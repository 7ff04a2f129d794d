#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA device and ``nvcc`` (the kernels are built from
``heyoka_tpu_torch/csrc`` into ``build/`` on first use), and exits non-zero
if anything is missing or any check fails.  Phases, one line each:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of the kernels, with its time, ptxas's register counts per
   kernel instance (B1/B2 come in one instance per lanes-a-block and
   layout) and the block shape of B1/B2 on the outer-Solar-System tape at
   10,240 lanes (``jet_kernels.block_shape``), its dynamic shared memory
   and its blocks an SM by the rule and by the runtime;
3. kernel B2 (``hy_jet_f64``) against ``jet_plain`` on the card: the
   outer-Solar-System tape at order 19 and 256 lanes, the jets in shared
   memory; coefficients agree to 1e-13 relative per order (normalised by
   the order's max over lanes);
4. kernel B1 (``hy_prop_f64``) against ``prop_plain``: the same lanes,
   one 64-step chunk; per-lane step counts and flags equal, state within
   1e-11 relative;
5. the slice: ``taylor_adaptive_batch(nbody(6), ..., tol=1e-15,
   high_accuracy=True, device="cuda")`` at 10,240 lanes,
   ``propagate_until(100.0)``: every lane lands on t = 100 exactly with
   ``time_limit``, both kernels ran, the relative energy drift is at most
   1e-12, and 4 lanes agree with the port's CPU run of the same lanes;
   then the same lanes through the rolled route (B3 and the per-step
   driver), timed beside it for ROADMAP A.16 and held to the fused
   route's states;
6. the time of one B2 launch and one 64-step B1 chunk at 10,240 lanes
   against their plain twins on the card (CUDA events), and the phase 3
   and 4 comparisons again at that width; then both kernels at every
   block shape they take (``jet_kernels.LANE_CHOICES`` lanes x 32 to 256
   threads), equal bit for bit to the default's, with their times, the
   blocks an SM holds and the fastest, on the outer-SS tape and on the
   Henon-Heiles and 3-body tapes, the Henon-Heiles default shape first
   held against ``jet_plain`` and ``prop_plain`` as in phases 3 and 4;
7. kernel B3 (``hy_jet_rolled_f64``) on the mascon-512 tape of
   ``benchmarks/mascon_bench.py`` at order 19 and 256 of its lanes,
   against ``jet_rolled_plain`` and against B2 on the same inputs: 1e-13
   relative per order, norms to the same bound; its literal aliases, the
   bytes a lane takes and its layout (the global one: a lane fits a
   block's shared memory, but one block an SM loses), the tables and
   coefficient doubles a lane-jet reads
   (``tools.roofline.rolled_traffic``), and B3 on the smem layout,
   forced, held to the same bounds;
8. the huge-tape slice: ``taylor_adaptive_batch(mascon(...), ...,
   tol=1e-15, high_accuracy=True, device="cuda")`` at 1,024 lanes on
   bound r ~ 2 orbits (``mascon_lanes``), one ``step()`` and
   ``propagate_until(T)`` over two orbital periods: the rolled route,
   only B3 launched, every lane on
   t = T exactly with ``time_limit``, the rotating-frame Jacobi integral
   kept to 1e-12, and 2 lanes agreeing with the port's CPU run; then the
   same lanes through the fused B1 route (B1 and B2 on their global
   layout: ``ROLLED_MIN_WIDTH`` raised while the integrator is built),
   timed beside it for ROADMAP A.16 and held to the rolled route's states;
   then both routes again on mascon-32, a tape of mid width;
9. the time of one B3 jet at 1,024 lanes on mascon-512 against
   ``jet_rolled_plain`` and B2, B3 at each block size (64, 128 and 256
   threads) on both layouts, equal bit for bit, and B2 against
   B3 on mascon-32/128/256
   and on the outer-Solar-System tape (the data behind
   ``taylor.batch.ROLLED_MIN_WIDTH``); B2 takes the global layout from
   mascon-128 up (one lane's jet over 227 KB), and is held against
   ``jet_plain`` there at 1e-13 per order, norms too;
10. kernel B4 (``hy_phase_f64``) against ``phase_plain`` on the card, on
    the tapes of ``tools.cases.phase_cases`` (the pendulum, five mixed
    systems, two more for the hyperbolic and logical ops, and one system
    per op), which together hold every op of ``convert.PHASE_OPS``: order
    19, 1,024 lanes, from ``lo = 1`` and from ``lo = 9`` on a buffer whose
    lower orders came from the twin; 1e-13 relative per order, norms to
    the same bound; then B4 at every block shape and layout it takes
    (``jet_phase.sweep_shapes``, forced) from both, each equal bit for bit
    to the default launch;
11. the pendulum slice: ``taylor_adaptive_batch(pendulum(), ...,
    tol=1e-15, high_accuracy=True, device="cuda")`` at 10,240 librating
    lanes, ``propagate_until(100.0)``: only B4 launched, every lane on
    t = 100 exactly with ``time_limit``, the relative energy drift at
    most 1e-12, 4 lanes agreeing with the port's CPU run; then its first
    10 time units again, without and with ``torch.profiler``, for the
    device's busy and idle shares;
12. the time of B4 against ``phase_plain`` on the card on three inputs:
    10,240 pendulum lanes, 1,024 lanes of the widest mixed tape (one whole
    ``jet_phase`` beside each) and 10,240 outer-Solar-System lanes from
    lo = 9 (phase 14's buffer in f64); for each the chosen block shape and
    layout, the time at every forced shape (each equal to the default bit
    for bit) and, on the smem layout, the staging alone with its share of
    the time (B4's times replayed from a CUDA graph: a pendulum jet takes
    about as long as its launch from Python);
13. the convolution microbenchmark (kernel T1, ``tools.microbench_conv.
    run``): ``hy_conv_f32`` and ``hy_conv_dd`` at K = 20, N = 204,800
    against their plain versions (bit for bit) and the f64 reference,
    their times (replayed from a CUDA graph, and from back-to-back
    launches beside) and the grouped ``conv1d`` (cuDNN's TF32 off) beside
    the f32 kernel, ``hy_conv_dd_direct`` (the ring's yardstick: the same
    lane body over plain loads) beside T1-dd; then ``hy_conv_dd`` and the
    yardstick at every tile (``tools.microbench_conv.sweep``), each equal
    to the rule's launch bit for bit, with its time, shared memory and
    blocks an SM, the ring's per-tile clock trace, and T1-dd beside its
    parent's time and the predictions;
14. the f32 phase prototype (kernel T2, ``tools.proto_phase.run``):
    ``hy_proto_phase_f32`` on the outer-Solar-System tape, orders 9..19 at
    10,240 lanes, against its plain body (1e-5 of each order's largest
    magnitude), and kernel B4 in f64 from lo = 9 on the same buffer: the
    times of both, their block shapes, T2 at every block shape (each
    equal to the default bit for bit) and the per-order difference of f32
    against f64.
15. ``propagate_grid`` at full width on the three routes, each through the
    per-step driver over its jet: the outer SS on phase 5's 10,240 lanes
    over ``np.linspace(0, 100, 101)`` (only B2 launched, every lane
    ``time_limit``, the last row equal to phase 5's fused landing state to
    1e-11, the energy drift over every row at most 1e-12, 4 lanes equal to
    the port's CPU run to 1e-11), mascon-512 on phase 8's 1,024 lanes over
    two periods at 70 points (only B3, the Jacobi drift over every row at
    most 1e-12, 2 lanes against the CPU) and the pendulum on phase 11's
    10,240 lanes to t = 100 at 1,001 points (only B4, the energy drift at
    most 1e-12, 4 lanes against the CPU); each route's lane-steps/s beside
    its ``propagate_until``'s, and the first tenth of the outer-SS grid
    under ``torch.profiler`` for the device's idle share;
16. dense and continuous output: ``propagate_until(..., c_output=True)`` on
    the outer SS (only B2) and mascon-512 (only B3) at full width, the
    records' peak device memory, ``n_steps`` equal to ``nsteps``, the
    continuous output at phase 15's grid times equal to its rows to 1e-13
    per lane (and whether bit for bit); ``update_d_output`` at mid-step
    after one ``step()`` on each route against the CPU run; a pickle round
    trip of each route's integrator on the card, then one more
    ``propagate_until`` from the original and the copy, equal bit for bit.

17. the event rows: kernels B2, B3 and B4 on tapes with event equations
    (their sv-func rows after the state rows) against their plain
    versions, 1e-13 relative per order, norms too: B2 on Henon-Heiles with
    its event y and on the outer SS with a close approach at 10,240 lanes,
    B3 on mascon-512 with the alias-form x - 1.5 and an impact at 1,024
    (the alias-form event costs 8 bytes a lane, its order 0), B4 on the
    pendulum with v and x at 10,240; their times;
18. the Henon-Heiles Poincare batch (``benchmarks/hh_event_bench.py``):
    ``nt_event(y, direction=positive)`` to t = 200 at tol 1e-15 at 10,240
    and 1,024 lanes: only B2 on the event path, one launch a lockstep
    step; the energy drift at most 1e-12; 64 lanes' hits equal to the
    port's CPU run in count and sign, times within 1e-10; at 1,024 the
    same run with ``c_output``, |y| at most 1e-12 at every hit; the rates
    with the event and without it (fused B1) in turns, their ratio; the
    device idle share on a tenth of the run (profiler); the isolation's
    share of an event step;
19. terminal events and callbacks at scale: the pendulum at 10,240 lanes
    (B4) with ``t_event(v, callback=continue)`` to t = 20 (the resume
    loop's rounds and rate, drift at most 1e-12); mascon-512 at 1,024 (B3)
    with the alias-form ``nt_event(x - 1.5)`` and an impact over two
    orbits (Jacobi drift at most 1e-12, the hits); the outer SS at 10,240
    (B2) with a host callback that stops after 10 steps (``cb_stop`` on
    every lane); ``propagate_grid`` with the HH event to t = 20 over 201
    points (rows within 1e-12 of the event-free grid's, hits equal to
    ``propagate_until``'s);
20. the scalar integrator on the card: kernels B1-B4 at 1 and 3 lanes
    against their plain versions (B4 at every block shape, its buffer
    between guards that must stay untouched); ``taylor_adaptive`` on lane
    0 of phase 5 (B1 and B2 only, ``time_limit`` on t = 100, drift at most
    1e-12, equal to phase 5's lane to 1e-13 and whether bit for bit), on
    the pendulum (B4 only) and on mascon-512 (B3 only: one ``step()`` and
    a tenth of phase 8's horizon), each held to a 3-lane batch's lane 0
    on the card and to the CPU run; ``step()`` latency at one lane (the
    quartiles of 200 steps after 20) on the three routes, each route's
    kernel time at one lane and the device's busy share of 50 more steps
    under ``torch.profiler``; each scalar's
    steps/s; the pendulum with ``t_event(v, callback=...)`` going on twice
    and ``nt_event(x, cb(ta, t, d_sgn))`` held to the CPU run; the
    per-lane ``AngleReducer`` on circulating pendulums, scalar and at
    1,024 lanes, and what its ``torch.func.vmap`` costs the per-step
    driver there (the reducer against no callback in turns, and one
    ``callback.apply`` call beside the same reduction written for the
    batch);
21. ensembles at full width: ``ensemble_propagate_until/for`` of the
    outer-SS template over phase 5's 10,240 lanes (B1 and B2; phase 5's
    states), ``ensemble_propagate_grid`` of the pendulum over phase 15's
    grid (B4; phase 15's rows), the HH ``nt_event`` ensemble to t = 200
    (B2; phase 18's hits) and to t = 50 with ``_for``, the per-instance
    fallbacks (a grid with events, terminal callbacks) on 8 pendulum
    instances, each equal to its own scalar run,
    ``ensemble_propagate_until_batch`` with a 1,024-lane template and
    n_iter = 10, and ``mesh=["cuda:0"]`` equal to the plain call; the
    ensemble table (until/for/grid x plain/events and the terminal
    callbacks): each ensemble beside the raw batch on the same lanes in
    turns (the raw batch built before its timer starts, its constructor
    timed apart), their ratio, its first call against a later one;
22. variational systems and compiled functions: (a) BASELINE config 4
    (``benchmarks/var_bench.py``): ``var_ode_sys(pcr3bp(mu=0.01),
    VarArgs.vars, 1)`` (128 columns), kernels B2 and B1 against their
    twins on its lanes, then 2,048 and 10,240 lanes (1e-6 N(0, 1), lane 0
    unperturbed) to t = 10 at tol 1e-15 (fused B1 and B2; every lane
    ``time_limit``, every STM's |det - 1| at most 1e-10, the Jacobi
    constant, the port's cfunc on the card, kept to 1e-12), lane 0 against
    the scalar ``taylor_adaptive(vsys, ic)`` (1e-13, and whether bit for
    bit), 4 lanes against the CPU run (1e-11), one ``step()`` (B2), the
    lane-steps/s and the construction time; (b) the CR3BP at order 2
    (1,355 columns) on kernel B3: its layout (history rows, aliases, bytes
    a lane), B3 against its twin (1e-13 per order) and its time, 1,024
    lanes about a bound orbit to t = 12 (~100 steps; only B3, Jacobi drift
    at most 1e-12, 2 lanes against the CPU), the Taylor map at deviations
    d and d / 2 (d ~ 1e-4) against direct integrations of the displaced
    lanes, its error 6-10x smaller at d / 2 on every lane; (c) the
    2-[16]-2 tanh neural ODE wrt its 82 parameters (1,069 columns) on
    kernel B4: its block shape, B4 against its twin (1e-13 per order) and
    its time (CUDA graph), 1,024 lanes to t = 1 (only B4), 8 parameters'
    sensitivities against central differences (step 1e-6, 1e-6 relative)
    and 4 lanes against the CPU run (1e-12); (d) the cfunc at 2^20 points
    on the card against the CPU (1e-14 relative, and whether bit for
    bit): the CR3BP's Jacobi constant, the outer SS's energy, the Jacobi
    constant with mu a parameter of each point and the rotating frame's
    positions in the inertial one at each point's time; evaluations/s
    and the device kernels a call launches (``torch.profiler``); the
    share of 2^20 inputs where torch's sqrt on the CPU and on the card
    differs from numpy's.
23. BASELINE config 5 (``benchmarks/geopot_bench.py``,
    ``benchmarks/sgp4_bench.py``; the systems, lanes and satellites from
    ``heyoka_tpu_torch/tools/cases.py``): (a) ``ensemble_propagate_until``
    of a scalar ``taylor_adaptive`` template of the EGM2008 geopotential
    at degree 4 in km (270 ops) over 10,240 lanes perturbed by 1e-6 for
    one day at tol 1e-15 (only B1 and B2; every instance ``time_limit`` on
    t = 86,400; the energy ``0.5 |v|^2 - U``, the port's cfunc on the
    card, kept to 1e-12 on every lane; equal to the raw batch bit for
    bit; 4 lanes against the CPU run), B1/B2 against their twins on the
    tape, B1's time a chunk, and the device's idle share over a tenth of
    the day (profiler); (b) degree 10 (1,248 ops) on 1,024 of those lanes
    for a day (only B3, drift at most 1e-12, 2 lanes against the CPU over
    the first 5,600 s), B3 against its twin and its time, and the same
    lanes through the fused B1 route (``ROLLED_MIN_WIDTH`` raised while
    the integrator is built; ROADMAP A.16), timed beside it and held to
    its states; (c) the degree-4 system plus NRLMSISE-00 thermoNET drag
    (2,388 ops, four parameters a lane: space weather and ballistic
    coefficient) on 1,024 lanes for a day (only B4, order 0 in torch;
    every lane's energy falls; 2 lanes against the CPU over 5,600 s), B4
    against its twin and its time (CUDA graph), the idle share; (d)
    ``SGP4Propagator`` on the card: the Spacetrack Report #3 vectors,
    16,384 satellites at 32 epochs over a day (64 against the CPU to
    1e-12), ``diff_order=1`` on 1,024 satellites against the CPU, UTC
    dates against the same instants as minutes, satellite-epochs/s and
    the device kernels a call; (e) ``lagrange_prop`` through the cfunc at
    2^20 points against the CPU (1e-13).  Each path's lane-steps/s beside
    the card's name and power limit.
24. the series slice (ROADMAP A.14; ``heyoka_tpu_torch/tools/cases.py``
    ``elp_sys``, ``p9_sys``): (a) kernel S1's two entries, S1-L
    (``hy_series_lin_f64``, the linear terms' closed form on the FP64
    tensor cores) and S1-G (``hy_series_gen_f64``, the recurrence),
    each alone against its class's twin on each of the 24 series ops of
    the complete ELP2000 tape (9 ops, 37,863 terms) and of planet 9's q/p
    at thresh 1e-9 (15 ops, 4,479 terms, all linear), then the grouped
    step (every op of a tape in one work list) against the twin, at
    10,240 lanes, u0 from U(-0.5, 0.5), u1 = 1, K = 19: every order
    within 1e-13 of its sum of the terms' magnitudes, two runs bit for
    bit; each entry's time over the ELP2000 step, its twin's, its bound,
    the recurrence's bound over every term, and the torch closed form of
    class L (few calls a series, the ``library_ms`` yardstick);
    (b) the complete ELP2000 ODE (``x' = c_x 1e-10``, as
    ``benchmarks/vsop2013_cartesian.py``) on 10,240 lanes starting at
    U(-0.5, 0.5) centuries, zero state, tol 1e-15, ``propagate_for(0.02)``
    on the card: only S1 and B4 launched, each S1 entry once a step (as
    many launches as B4's), every lane ``time_limit`` on its target bit
    for bit, 16 lanes against the port's CPU run (1e-12 relative), steps
    a lane, lane-steps/s, the idle share and S1's share of the busy time
    (profiler), B4's time a launch; the same at 256 lanes (the benchmark's
    width); (c) planet 9 at thresh 1e-7 on 1,024 lanes through the series
    route (S1 + B4) and the expanded tape (1,332 u-vars, B4 alone): the
    routes' states within 1e-12 relative, both rates; (d) the complete
    ELP2000 cfunc at 2^18 times on the card (evaluations/s; the 9 series
    within 1e-13 of their terms' magnitudes of the CPU twin's, the
    position within 1e-12 relative, on 1,024 of the points), the
    published ELP2000 vectors (thresh 1e-5, 0.05 km) and Pluto's
    inclination and node through the card.
25. the Earth-orientation slice (ROADMAP A.15, data part;
    ``heyoka_tpu_torch/tools/cases.py`` ``eo_sys``, ``eo_lanes``): (a)
    every quantity of the builtin EOP and SW tables (value and slope,
    ``eop_sw.interp0``) and ``dayfrac`` at 2^20 epochs uniform over each
    table's range and 1% beyond it (numpy rng 0) on the card against the
    same calls on the CPU: 1e-15 relative (1e-15 absolute for the angles),
    NaN in the same places, and their evaluations/s; (b) the full
    ``eo_dynamics(max_geo_degree=10, max_geo_order=10, Cb=par[0])``
    (IAU2006 at 1e-4, thermoNET drag, the builtin tables; 5,147 ops) on
    10,240 lanes (``geopot_lanes``, ``Cb`` uniform in 0.005-0.02 m^2/kg)
    from 2015-06-10 00:00 UTC over 5,600 s at tol 1e-15 on kernel B4:
    only B4 launched, every lane ``time_limit`` and finite, 2 lanes
    against the CPU over the first 600 s (1e-10); 1,024 of the lanes over
    a day beside phase 23 (c)'s rate on the same lanes, each ending below
    the Keplerian energy of its ``Cb = 0`` twin; B4 against its twin on
    the tape at 1,024 lanes (every order and the norms 1e-12), its time a
    launch (CUDA graph) at 1,024 and 10,240 lanes and its bound; the
    idle share and the torch kernels a step spends on order 0 (profiler,
    a tenth of the run); W, levels, layout, build times, the buffer's
    bytes; (c) ``tests/test_eop_sw.py``'s ``pm_x`` ODE through
    ``taylor_adaptive`` on the card against its trapezoid integral
    (1e-7).
26. float32 (ROADMAP C.4; kernel B4's f32 entry ``hy_phase_f32``): (a)
    B4-f32 against its f32 twin on every tape of phase 10 at order 8 (the
    order of tol 1e-6) on 1,024 lanes from lo = 1 and lo = 5, on phase
    11's 10,240 pendulum lanes (every forced block shape bit for bit) and
    on 10,240 outer-SS lanes at the f32 order, and on T2's outer-SS buffer
    at order 19 from lo = 9: each order within 1e-5 of its largest
    magnitude, two runs bit for bit, and B4-f32 against B4-f64 on the same
    inputs; B4-f32's and B4-f64's times in turns (CUDA graphs), the twin's,
    the bound; (b) the pendulum in f32 on phase 11's 10,240 lanes at tol
    1e-6 to t = 10 and then t = 100: only B4-f32 launched, f32 state, time
    and coefficients, every lane ``time_limit`` on t = 100 and finite,
    within 5e-4 of the f64 run at the same tol at t = 10
    (``test_float32_mode``'s bar) and 5e-3 at t = 100, the energy drift,
    16 lanes against the port's f32 CPU run, lane-steps/s beside the f64
    run's and phase 11's, the idle share (profiler over t < 10), and
    ``taylor_adaptive(..., dtype=float32)`` on one lane with the same
    checks; (c) the f32 cfunc at 2^20 points and SGP4 in f32 on phase 23
    (d)'s 16,384 satellites at 32 epochs against the CPU in f32 and the
    card in f64, their rates and SGP4's km and km/s from f64; (d)
    ``s11n``'s cache in a child process with no ``nvcc``: the built
    library packed, unpacked into a fresh directory, that directory
    enabled, B4 (f32 and f64) launched from the unpacked library and held
    to its twin;
27. the rest of C.4 in f32 and the native host runtime (ROADMAP A.22):
    (a) the Henon-Heiles Poincare batch of phase 18 in f32 (tol the f32
    epsilon) at 10,240 lanes to t = 20: only B4-f32 launched, the event
    rows isolated in f32, 64 lanes' hits against the port's f32 CPU run
    and every lane's against phase 18's f64 hits before t = 20 (count and
    sign equal, times within 2e-5), the energy drift, lane-steps/s beside
    phase 18's f64 event rate; (b) config 4's PCR3BP STM batch in f32 at
    2,048 lanes to t = 10: |det STM - 1|, states and Taylor map against
    the f64 run on the card and the f32 CPU run; (c) the complete ELP2000
    ODE in f32 at 10,240 lanes over 0.002 centuries (S1 in f64 on the
    widened f32 input, B4-f32) against the f64 card runs at the same tol
    and at 1e-15 and the f32 CPU run, then phase 25 (c)'s ``pm_x`` ODE in
    f32 against its f64 run and the CPU's; (d) ``backend="native"`` on the
    card's host (the runtime and the outer-SS stepper built by ``g++`` in
    a child process at a lower priority while phases 3-26 run): one
    outer-SS lane's ``step()`` latency beside the card's, and
    ``propagate_until(100)`` at 8, 64 and 256 lanes on the host and on the
    card, held to each other, with no kernel launched and no device event
    (``torch.profiler``) during the native runs, and the host's CPU model.

The line before the last is the kernels' JSON summary (each kernel's
launches on its path, its error against its plain version, its time, its
plain version's, its bound from ``tools.roofline`` and, where one torch
call computes the same function, that call's time; for B1-B4 also
``path_launches``, the launches on phases 15-16's, 17-19's, 20-21's, 22's
and 23's paths, and for B2-B4 ``event_rows_ms``, phase 17's times with event
rows, ``var_tape``, phase 22's time on its variational tape, and
``config5_tape``, phase 23's on its config-5 tape; the lines of S1's
two entries, S1-L ``hy_series_lin_f64`` and S1-G ``hy_series_gen_f64``,
are phase 24's (each entry's time over the ELP2000 step, S1-L's
``library_ms`` the torch closed form), B4's gains ``series_tapes`` and
``eo_tape``, phase 25's time on the ``eo_dynamics`` tape; B4-f32's row is phase 26's: its launches on the
f32 pendulum, its time at 10,240 pendulum lanes at order 8 beside
B4-f64's, its ``path_launches`` with phase 27's f32 paths, and S1's
with phase 27 (c)'s); the last line is
``{"ok": true, "device": {...}}``.  Each phase's
line carries ``t_s``, the seconds since the script started.
"""

import importlib
import json
import pickle
import re
import sys
import time

import numpy as np
import torch

import heyoka_tpu_torch as ht
from heyoka_tpu_torch import _build
from heyoka_tpu_torch import eop_sw as PE
from heyoka_tpu_torch.models import nbody
from heyoka_tpu_torch.taylor import jet_kernels as jk
from heyoka_tpu_torch.taylor import jet_phase as jp
from heyoka_tpu_torch.taylor import jet_rolled as jr
from heyoka_tpu_torch.taylor import series_jet as sj
from heyoka_tpu_torch.expr import series as PS
from heyoka_tpu_torch.taylor.compact import build_plan
from heyoka_tpu_torch.taylor.stepper import taylor_order_from_tol
from heyoka_tpu_torch.tools import (
    GCONST, IC, MASSES, cuda_ms, graph_ms, mascon_body, mascon_lanes,
    microbench_conv, proto_phase, smi_line,
)
from heyoka_tpu_torch.tools import roofline as rl
from heyoka_tpu_torch.tools.cases import (
    GEOPOT_IC, REPORT3, SGP4_TLE, drag_pars, drag_sys, elp_sys, eo_epoch,
    eo_lanes, eo_sys, geopot_energy, geopot_lanes, geopot_sys, p9_sys,
    pendulum_lanes, phase_cases, phase_lanes, series_times,
    sgp4_population,
)

TOL = 1e-15
B_CHECK = 256
B_MAIN = 10_240
T_END = 100.0
CHUNK = 64
FAR = 1000.0  # remaining time of the lone chunks: no lane nears its target
#: the 3-body tape's lanes (tests/test_torch_gpu.py's): these plus 0.01 N(0, 1)
NBODY3_IC = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0,
                      0, 1.5, 0, -0.8, 0, 0], float)
JET_RTOL = 1e-13
PROP_RTOL = 1e-11
DRIFT_MAX = 1e-12
REF_LANES = 4
REF_RTOL = 1e-10

MASCON_N = 512
MASCON_B = 1024
MASCON_T = 4.0 * np.pi * 2.0 ** 1.5  # two periods of an r = 2 orbit
MASCON_REF_LANES = 2
JACOBI_MAX = 1e-12
SWEEP_N = (32, 128, 256)
MID_N = 32  # phase 8's mid-width tape

#: kernel T1-dd before the ring (one thread a lane, its loads then its
#: arithmetic) replayed from a CUDA graph: the lower quartile, median and
#: upper quartile of its medians in ten alternating processes of
#: ``tools/same_bits.py t1``, and the ring's predictions, made before any
#: version of it ran, before its TMA version ran and before its one-stage
#: version ran (PERF.md, the T1 findings)
T1_DD_PARENT_MS = (0.06122, 0.06150, 0.06154)
T1_DD_PREDICTED_MS = {"first": (0.035, 0.045), "TMA ring": (0.050, 0.056),
                      "one stage": (0.057, 0.060)}

PHASE_B = 1024
PHASE_LO = 9  # the JAX route's split at mp_order = 8
PEND_B = 10_240
PEND_T = 100.0
PROFILE_T = 10.0  # the window of phase 11 timed under the profiler

GRID_N = 101  # phase 15: the outer SS's grid, one point a year
MASCON_GRID_N = 70
PEND_GRID_N = 1001
GRID_RTOL = 1e-11
COUT_RTOL = 1e-13  # phase 16: the continuous output against the grid rows

SOURCES = {"hy_series_lin_f64": "heyoka_tpu_torch/csrc/series_jet.cu",
           "hy_series_gen_f64": "heyoka_tpu_torch/csrc/series_jet.cu",
           "hy_jet_f64": "heyoka_tpu_torch/csrc/taylor_jet.cu",
           "hy_prop_f64": "heyoka_tpu_torch/csrc/taylor_jet.cu",
           "hy_jet_rolled_f64": "heyoka_tpu_torch/csrc/taylor_jet_rolled.cu",
           "hy_phase_f64": "heyoka_tpu_torch/csrc/taylor_phase.cu",
           "hy_phase_f32": "heyoka_tpu_torch/csrc/taylor_phase.cu",
           "hy_conv_f32": "heyoka_tpu_torch/csrc/conv_microbench.cu",
           "hy_conv_dd": "heyoka_tpu_torch/csrc/conv_microbench.cu",
           "hy_proto_phase_f32": "heyoka_tpu_torch/csrc/proto_phase.cu"}
#: kernel S1 replaces XLA code, not a Pallas kernel: ``_series_jet``
REPLACES = {"hy_series_lin_f64": "heyoka_tpu/expr/series.py:427",
            "hy_series_gen_f64": "heyoka_tpu/expr/series.py:427",
            "hy_jet_f64": "heyoka_tpu/taylor/pallas_phase.py:1604",
            "hy_prop_f64": "heyoka_tpu/taylor/pallas_phase.py:2454",
            "hy_jet_rolled_f64": "heyoka_tpu/taylor/pallas_phase.py:1842",
            "hy_phase_f64": "heyoka_tpu/taylor/pallas_phase.py:899",
            "hy_phase_f32": "heyoka_tpu/taylor/pallas_phase.py:899",
            "hy_conv_f32": "tools/microbench_pallas_conv.py:48",
            "hy_conv_dd": "tools/microbench_pallas_conv.py:92",
            "hy_proto_phase_f32": "tools/proto_pallas_phase.py:240"}
#: the kernels' names in ptxas's log, longest first where one name holds
#: another
PTXAS_NAMES = ("jet_rolled_kernel", "series_lin_kernel",
               "series_gen_kernel", "series_reduce_kernel", "jet_kernel",
               "prop_kernel",
               "proto_phase_kernel", "phase_kernel", "conv_f32_kernel",
               "conv_dd_ring", "conv_dd_direct")
#: block shapes of B1/B2 with the jets in shared memory timed in phase 6
#: (those whose lanes fit a block's shared memory)
SWEEP_LANES = jk.LANE_CHOICES
SWEEP_THREADS = jk.BLOCK_THREADS


def ptxas_name(line):
    """A kernel's name in a ptxas line, with its template arguments
    (``jet_kernel<3,smem>``, ``phase_kernel<f32,global>``, the staging
    alone ``phase_kernel<f64,smem,stage>``, T1-dd's trace instance
    ``conv_dd_ring<trace>``) where it has them."""
    fn = next(w for w in PTXAS_NAMES if w in line)
    if fn == "conv_dd_ring":
        return fn + ("<trace>" if fn + "ILb1E" in line else "")
    m = re.search(fn + r"ILi(\d+)EE", line)  # S1-L's row tiles
    if m:
        return f"{fn}<{m.group(1)}>"
    m = re.search(fn + r"ILi(\d+)ELb([01])E", line)
    if m:
        fn += f"<{m.group(1)},{'smem' if m.group(2) == '1' else 'global'}>"
    m = re.search(fn + r"I([fd]?)((?:Lb[01]E)+)E", line)
    if m:
        flags = re.findall(r"Lb([01])E", m.group(2))
        fn += "<" + {"f": "f32,", "d": "f64,"}.get(m.group(1), "") + (
            "smem" if flags[0] == "1" else "global") + (
            ",stage" if flags[1:] == ["0"] else "") + ">"
    return fn


T_START = time.perf_counter()


def say(phase, **kv):
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - T_START,
                      **kv}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def lanes(ic, B, seed):
    """``B`` copies of the initial conditions, each coordinate perturbed by
    a relative 1e-8 (the north-star benchmark's ensemble)."""
    rng = np.random.default_rng(seed)
    return ic[None, :] + np.abs(ic)[None, :] * (
        rng.uniform(-1, 1, (B, ic.size)) * 1e-8)


def energy(st, masses, G):
    """Total energy per lane of an N-body state (B, 6N), f64."""
    s = st.reshape(st.shape[0], -1, 6)
    r, v = s[:, :, :3], s[:, :, 3:]
    m = torch.as_tensor(masses, dtype=st.dtype, device=st.device)
    e = 0.5 * (m * (v * v).sum(2)).sum(1)
    n = len(masses)
    for i in range(n):
        for j in range(i + 1, n):
            d = torch.linalg.vector_norm(r[:, i] - r[:, j], dim=1)
            e = e - G * masses[i] * masses[j] / d
    return e


def jacobi(st, kw):
    """The rotating-frame Jacobi integral per lane (``mascon_energy``):
    0.5 |v|^2 - G sum_i m_i / |r - p_i| + 0.5 ((w.r)^2 - |w|^2 |r|^2)."""
    f64 = dict(dtype=st.dtype, device=st.device)
    r, v = st[:, :3], st[:, 3:]
    p = torch.as_tensor(kw["positions"], **f64)
    m = torch.as_tensor(kw["masses"], **f64)
    w = torch.as_tensor(kw["omega"], **f64)
    d = torch.linalg.vector_norm(r[:, None, :] - p[None], dim=2)
    wr = r @ w
    return (0.5 * (v * v).sum(1) - kw["Gconst"] * (m / d).sum(1)
            + 0.5 * (wr * wr - (w @ w) * (r * r).sum(1)))


def mascon_tapes(kw, order, dev):
    """The mascon tape for kernel B3 and for kernel B2."""
    plan = build_plan(ht.taylor_decompose_sys(ht.models.mascon(**kw)), order)
    arrays = ht.plan_to_arrays(plan)
    return jr.RolledTape(arrays, dev), jk.JetTape(arrays, dev)


def per_order_rel(a, b):
    """(n, K+1, B) coefficient blocks: max |a - b| per order over columns
    and lanes, relative to the order's max |b|."""
    scale = b.abs().amax(dim=(0, 2))
    return ((a - b).abs().amax(dim=(0, 2))
            / torch.where(scale > 0, scale, torch.ones_like(scale)))


def timed(ms_runs, plain_runs, bnd):
    """A jet kernel's entry of the kernels' line: the mean of its two
    windows, its plain twin's, and its bound; no single torch call computes
    a jet, so ``library_ms`` is None."""
    return dict(ms=sum(ms_runs) / 2, plain_ms=sum(plain_runs) / 2,
                library_ms=None, bound_ms=bnd["bound_ms"],
                bound_by=bnd["bound_by"])


def main():
    # -- 1. the card --------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    smi = smi_line()
    print(smi, flush=True)
    say(1, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])

    dev = torch.device("cuda")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    # phase 27 (d)'s host libraries, built beside the device phases
    warm_proc = start_native_build()
    try:
        device_phases(dev, smi, build_s, warm_proc)
    finally:
        if warm_proc.poll() is None:
            warm_proc.kill()
            warm_proc.communicate()


def device_phases(dev, smi, build_s, warm_proc):
    """Phases 2-27 (the module's docstring), then the kernels' line and the
    last line."""
    log_path = _build.library_path().with_suffix(".log")
    log = log_path.read_text() if log_path.exists() else ""
    ptxas, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ptxas_name(ln)
        elif fn and ("registers" in ln or "spill" in ln):
            ptxas.setdefault(fn, []).append(
                ln.split("ptxas info    : ")[-1].strip())
    sys_ = nbody(6, masses=MASSES, Gconst=GCONST)
    order = taylor_order_from_tol(TOL)
    plan = build_plan(ht.taylor_decompose_sys(sys_), order)
    tape = jk.JetTape(ht.plan_to_arrays(plan), dev)
    layout = jk.layout_report(tape, B_MAIN, dev)
    # the shape of a B1/B2 block on the outer-SS tape at the main path's
    # lanes, its dynamic shared memory with the tables, and the blocks an
    # SM holds by the rule and by the runtime; phase 7 gives mascon-512's
    # (the global layout)
    launch_smem = jk._launch_cfg(tape, B_MAIN, dev)[2]
    say(2, build_s=build_s, ptxas=ptxas,
        smem_per_block=dict(layout, launch_bytes=launch_smem,
                            occupancy=jk.occupancy(
                                layout["lanes_per_block"], layout["threads"],
                                launch_smem)))
    n_eq = tape.n_eq
    no_pars = torch.zeros((0, B_CHECK), dtype=torch.float64, device=dev)

    # -- 3. B2 against jet_plain ----------------------------------------------
    st = torch.as_tensor(lanes(IC, B_CHECK, 1).T.copy(), device=dev)
    tc_k, nrm_k = jk.jet(tape, st, no_pars)
    torch.cuda.synchronize()
    tc_p, nrm_p = jk.jet_plain(tape, st, no_pars)
    rel = per_order_rel(tc_k, tc_p)
    jet_err = float((tc_k - tc_p).abs().max())
    check(bool(torch.isfinite(tc_k).all()), "B2: non-finite coefficients")
    check(float(rel.max()) <= JET_RTOL,
          f"B2 vs jet_plain: per-order relative error {float(rel.max())}")
    check(bool(torch.allclose(nrm_k, nrm_p, rtol=JET_RTOL, atol=0)),
          "B2 vs jet_plain: norms")
    say(3, B=B_CHECK, order=order, W=tape.width, layout=layout,
        max_rel_per_order=float(rel.max()), max_abs_err=jet_err,
        tol=JET_RTOL)

    # -- 4. B1 against prop_plain ---------------------------------------------
    f64 = dict(dtype=torch.float64, device=dev)
    aux = torch.stack([torch.full((B_CHECK,), float("inf"), **f64),
                       torch.ones(B_CHECK, **f64),
                       torch.full((B_CHECK,), FAR, **f64),
                       torch.zeros(B_CHECK, **f64),
                       torch.ones(B_CHECK, **f64)])
    auxi = torch.full((1, B_CHECK), 2**31 - 1, dtype=torch.int32, device=dev)
    sk, ofk, oik = jk.prop(tape, st, no_pars, aux, auxi, CHUNK, True)
    torch.cuda.synchronize()
    sp, ofp, oip = jk.prop_plain(tape, st, no_pars, aux, auxi, CHUNK, True)
    check(torch.equal(oik, oip), "B1 vs prop_plain: n_taken/near/err differ")
    check(bool((oik[0] == CHUNK).all()), "B1: a lane stopped early")
    prop_rel = float(((sk - sp).abs().amax(1) / sp.abs().amax(1)).max())
    prop_err = float((sk - sp).abs().max())
    check(prop_rel <= PROP_RTOL, f"B1 vs prop_plain: state {prop_rel}")
    acc_rel = float(((ofk[0] - ofp[0]).abs() / ofp[0].abs()).max())
    check(acc_rel <= PROP_RTOL, f"B1 vs prop_plain: time {acc_rel}")
    say(4, B=B_CHECK, steps=CHUNK, layout=layout, state_max_rel=prop_rel,
        max_abs_err=prop_err, time_max_rel=acc_rel, tol=PROP_RTOL)

    # -- 5. the slice ---------------------------------------------------------
    ics = lanes(IC, B_MAIN, 0)
    kw = dict(tol=TOL, high_accuracy=True)
    warm = ht.taylor_adaptive_batch(sys_, ics[:CHUNK], device=dev, **kw)
    warm.propagate_until(1.0)
    ta = ht.taylor_adaptive_batch(sys_, ics, device=dev, **kw)
    e0 = energy(torch.as_tensor(ics, device=dev), MASSES, GCONST)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    oc, min_h, max_h, nsteps = ta.propagate_until(T_END)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(jk.LAUNCHES)
    check(launches["jet"] > 0 and launches["prop"] > 0,
          f"the slice did not run both kernels: {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in oc),
          "the slice: an outcome is not time_limit")
    check(bool((ta.dtime[0] == T_END).all() and (ta.time == T_END).all()),
          "the slice: a lane did not land on the target exactly")
    st_end = ta.state
    check(st_end.shape == (B_MAIN, n_eq) and bool(np.isfinite(st_end).all()),
          "the slice: bad final state")
    e1 = energy(torch.as_tensor(st_end, device=dev), MASSES,
                GCONST)
    drift = float(((e1 - e0).abs() / e0.abs()).max())
    check(drift <= DRIFT_MAX, f"the slice: energy drift {drift}")
    ref = ht.taylor_adaptive_batch(sys_, ics[:REF_LANES], device="cpu", **kw)
    ref_oc = ref.propagate_until(T_END)[0]
    ref_rel = float(np.abs(st_end[:REF_LANES] - ref.state).max()
                    / np.abs(ref.state).max())
    check(ref_oc == oc[:REF_LANES] and ref_rel <= REF_RTOL,
          f"the slice vs the CPU run: {ref_rel}")
    steps = int(nsteps.sum())
    rolled = rolled_route(sys_, ics, kw, st_end, dev)
    say(5, B=B_MAIN, t_end=T_END, wall_s=wall, lane_steps=steps,
        steps_per_s=steps / wall, mean_steps_per_lane=steps / B_MAIN,
        launches=launches, energy_drift_max_rel=drift,
        cpu_ref_max_rel=ref_rel, engine=ta.engine_report(),
        rolled_route=rolled)
    ss_until = dict(wall_s=wall, lane_steps=steps, steps_per_s=steps / wall)

    # -- 6. kernel vs plain at 10,240 lanes -----------------------------------
    stm = torch.as_tensor(lanes(IC, B_MAIN, 2).T.copy(), device=dev)
    np_m = torch.zeros((0, B_MAIN), **f64)
    aux_m = torch.stack([torch.full((B_MAIN,), float("inf"), **f64),
                         torch.ones(B_MAIN, **f64),
                         torch.full((B_MAIN,), FAR, **f64),
                         torch.zeros(B_MAIN, **f64),
                         torch.ones(B_MAIN, **f64)])
    auxi_m = torch.full((1, B_MAIN), 2**31 - 1, dtype=torch.int32,
                        device=dev)
    runs = {
        "jet": (lambda: jk.jet(tape, stm, np_m),
                lambda: jk.jet_plain(tape, stm, np_m)),
        "prop": (lambda: jk.prop(tape, stm, np_m, aux_m, auxi_m, CHUNK),
                 lambda: jk.prop_plain(tape, stm, np_m, aux_m, auxi_m,
                                       CHUNK)),
    }
    t = {}
    for name, (kern, plain) in runs.items():
        p1 = cuda_ms(plain, 1)
        k1 = cuda_ms(kern, 3)
        k2 = cuda_ms(kern, 3)
        p2 = cuda_ms(plain, 1)
        t[name] = ([k1, k2], [p1, p2])
    # the same comparisons as phases 3 and 4, at the main path's width
    tc_k, nrm_k = runs["jet"][0]()
    tc_p, _ = runs["jet"][1]()
    rel_m = float(per_order_rel(tc_k, tc_p).max())
    check(rel_m <= JET_RTOL, f"B2 vs jet_plain at B={B_MAIN}: {rel_m}")
    sk, ofk, oik = runs["prop"][0]()
    sp, _, oip = runs["prop"][1]()
    check(torch.equal(oik, oip), f"B1 vs prop_plain at B={B_MAIN}: flags")
    prop_rel_m = float(((sk - sp).abs().amax(1) / sp.abs().amax(1)).max())
    check(prop_rel_m <= PROP_RTOL,
          f"B1 vs prop_plain at B={B_MAIN}: state {prop_rel_m}")
    jet_err = max(jet_err, float((tc_k - tc_p).abs().max()))
    prop_err = max(prop_err, float((sk - sp).abs().max()))
    # bounds: B2 one jet a lane; B1 one jet a step taken, one more where a
    # lane stopped on near or err, and the update of every step taken
    jet_fl = rl.jet_flops(tape.arrays)
    tables = (tape.itab, tape.dtab)
    n_jets = int(oik[0].sum() + (oik[1] | oik[2]).sum())
    n_steps = int(oik[0].sum())
    bounds = {
        "jet": rl.bound(jet_fl * B_MAIN,
                        rl.nbytes(stm, np_m, *tables, tc_k, nrm_k),
                        torch.float64),
        "prop": rl.bound(n_jets * jet_fl
                         + n_steps * rl.step_flops(n_eq, order),
                         rl.nbytes(stm, np_m, aux_m, auxi_m, *tables, sk,
                                   ofk, oik), torch.float64)}
    times = {name: dict(timed(*t[name], bounds[name]), **layout)
             for name in runs}
    shapes = block_shapes(tape, stm, np_m, aux_m, auxi_m, (tc_k, nrm_k),
                          (sk, ofk, oik))
    small = dict(hh=shape_sweep("hh", dev, twins=True),
                 nbody3=shape_sweep("nbody3", dev))
    say(6, B=B_MAIN, chunk_steps=CHUNK, nvidia_smi=smi,
        jet_max_rel_per_order=rel_m, prop_state_max_rel=prop_rel_m,
        **{name: dict(times[name], ms_runs=t[name][0],
                      plain_ms_runs=t[name][1], **bounds[name])
           for name in runs}, block_shapes=shapes, small_tapes=small)

    rolled, mascon_until = huge_tapes(dev, order, smi)
    phased, pend_until = phase_tapes(dev, order, smi)
    convs = conv_tool(dev, smi)
    proto = proto_tool(dev, smi)

    until = {"outer_ss": ss_until, "mascon512": mascon_until,
             "pendulum": pend_until}
    grids = grid_paths(dev, smi, sys_, ics, st_end, until)
    couts = cout_paths(dev, smi, sys_, grids)
    # each kernel's launches on the new paths, each path counted alone
    times["jet"]["path_launches"] = dict(
        propagate_grid=grids["outer_ss"]["launches"]["jet"],
        c_output=couts["outer_ss"]["jet"])
    rolled[2]["path_launches"] = dict(
        propagate_grid=grids["mascon512"]["launches"]["jet_rolled"],
        c_output=couts["mascon512"]["jet_rolled"])
    phased[2]["path_launches"] = dict(
        propagate_grid=grids["pendulum"]["launches"]["phase"])
    # the event paths (phases 17-19): each kernel's launches on them, its
    # event rows' error and time
    ev_errs, ev_rows = event_rows(dev, smi, order)
    hh, hh_hits = hh_poincare(dev, smi)
    evp = event_paths(dev, smi, sys_, ics)
    times["jet"]["path_launches"].update(
        hh_events=hh[f"B{HH_B}"]["launches"]["jet"],
        hh_events_b1024=hh[f"B{HH_B_REF}"]["launches"]["jet"],
        hh_grid_events=evp["hh_grid_events"]["launches"]["jet"],
        outer_ss_host_callback=evp["outer_ss_host_callback"]["launches"][
            "jet"])
    times["prop"]["path_launches"] = dict(
        hh_events=hh[f"B{HH_B}"]["launches"]["prop"],
        hh_without_events=hh[f"B{HH_B}"]["plain_launches"]["prop"])
    rolled[2]["path_launches"]["mascon512_events"] = evp[
        "mascon512_events"]["launches"]["jet_rolled"]
    phased[2]["path_launches"]["pendulum_te_callback"] = evp[
        "pendulum_te_callback"]["launches"]["phase"]
    for row, key in ((times["jet"], "b2_hh"), (rolled[2], "b3_mascon512"),
                     (phased[2], "b4_pendulum")):
        row["event_rows_ms"] = ev_rows[key]["ms_runs"]
    times["jet"]["event_rows_ms_outer_ss"] = ev_rows["b2_outer_ss"][
        "ms_runs"]
    jet_err = max(jet_err, ev_errs["jet"])
    rolled = (rolled[0], max(rolled[1], ev_errs["jet_rolled"]), rolled[2])
    phased = (phased[0], max(phased[1], ev_errs["phase"]), phased[2])
    # the scalar integrator's and the ensembles' paths (phases 20-21): each
    # kernel's launches on each path, counted alone; the kernels at 1 and
    # 3 lanes against their plain versions
    sc_paths, few_errs = scalar_paths(dev, smi, sys_, ics, st_end, tape,
                                      order)
    ens_paths = ensemble_paths(dev, smi, sys_, ics, st_end,
                               grids["pendulum"]["rows"], hh_hits)
    for key, row in (("jet", times["jet"]), ("prop", times["prop"]),
                     ("jet_rolled", rolled[2]), ("phase", phased[2])):
        row.setdefault("path_launches", {}).update(
            {f"scalar_{p}": n[key] for p, n in sc_paths.items() if n[key]})
        row["path_launches"].update(
            {f"ensemble_{p}": n[key] for p, n in ens_paths.items() if n[key]})
    jet_err = max(jet_err, few_errs["jet"])
    prop_err = max(prop_err, few_errs["prop"])
    rolled = (rolled[0], max(rolled[1], few_errs["jet_rolled"]), rolled[2])
    phased = (phased[0], max(phased[1], few_errs["phase"]), phased[2])

    # phase 22: variational systems and compiled functions; each kernel's
    # launches on its paths, and its time and error on its variational tape
    var_rows, var_launch = var_paths(dev, smi, order)
    for key, row in (("jet", times["jet"]), ("prop", times["prop"]),
                     ("jet_rolled", rolled[2]), ("phase", phased[2])):
        row["path_launches"].update(
            {p: n[key] for p, n in var_launch.items() if n[key]})
        v = var_rows[key]
        row["var_tape"] = dict(
            tape={"jet": "pcr3bp var-o1", "prop": "pcr3bp var-o1",
                  "jet_rolled": "cr3bp var-o2",
                  "phase": "neural ODE var wrt params"}[key],
            ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
            bound_by=v["bound_by"], max_abs_err=v["max_abs_err"])
    jet_err = max(jet_err, var_rows["jet"]["max_abs_err"])
    prop_err = max(prop_err, var_rows["prop"]["max_abs_err"])
    rolled = (rolled[0], max(rolled[1], var_rows["jet_rolled"][
        "max_abs_err"]), rolled[2])
    phased = (phased[0], max(phased[1], var_rows["phase"]["max_abs_err"]),
              phased[2])

    # phase 23: BASELINE config 5; each kernel's launches on its paths,
    # and its time and error on its config-5 tape
    c5_rows, c5_launch = config5_paths(dev, smi, order)
    for key, row in (("jet", times["jet"]), ("prop", times["prop"]),
                     ("jet_rolled", rolled[2]), ("phase", phased[2])):
        row["path_launches"].update(
            {p: n[key] for p, n in c5_launch.items() if n[key]})
        v = c5_rows[key]
        row["config5_tape"] = dict(
            tape={"jet": "geopotential degree 4",
                  "prop": "geopotential degree 4",
                  "jet_rolled": "geopotential degree 10",
                  "phase": "degree 4 + thermoNET drag"}[key],
            ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
            bound_by=v["bound_by"], max_abs_err=v["max_abs_err"])
    jet_err = max(jet_err, c5_rows["jet"]["max_abs_err"])
    prop_err = max(prop_err, c5_rows["prop"]["max_abs_err"])
    rolled = (rolled[0], max(rolled[1], c5_rows["jet_rolled"][
        "max_abs_err"]), rolled[2])
    phased = (phased[0], max(phased[1], c5_rows["phase"]["max_abs_err"]),
              phased[2])

    # phase 24: the series slice; the rows of S1's two entries, B4's
    # launches and time on the series tapes
    s1_rows, b4_series, ser_launch = series_paths(dev, smi, order)
    phased[2]["path_launches"].update(
        {p: n["phase"] for p, n in ser_launch.items() if n["phase"]})
    phased[2]["series_tapes"] = b4_series
    for entry, (_, row) in s1_rows.items():
        key = sj.COUNTERS[entry]
        row["path_launches"] = {p: n[key] for p, n in ser_launch.items()
                                if n[key]}

    # phase 25: the Earth-orientation slice; B4's launches and time on the
    # eo_dynamics tape
    b4_eo, eo_launch = eo_paths(dev, smi, order)
    phased[2]["path_launches"].update(
        {p: n["phase"] for p, n in eo_launch.items() if n["phase"]})
    phased[2]["eo_tape"] = b4_eo
    phased = (phased[0], max(phased[1], b4_eo["max_abs_err"]), phased[2])

    # phase 26: float32; B4-f32's row, its launches on the f32 pendulum
    f32_row = f32_paths(dev, smi, order, pend_until)

    # phase 27: C.4's remainder in f32 and the native host runtime;
    # B4-f32's and S1's launches on its paths
    c4_launch = c4_native_paths(dev, smi, sys_, ics, hh, hh_hits, warm_proc)
    f32_row[2]["path_launches"].update(
        {p: n["phase_f32"] for p, n in c4_launch.items() if n["phase_f32"]})
    for entry, (_, row) in s1_rows.items():
        key = sj.COUNTERS[entry]
        row["path_launches"].update(
            {p: n[key] for p, n in c4_launch.items() if n[key]})

    rows = [*((entry, ser_launch["elp2000_complete"][sj.COUNTERS[entry]],
               err, row) for entry, (err, row) in s1_rows.items()),
            ("hy_jet_f64", launches["jet"], jet_err, times["jet"]),
            ("hy_prop_f64", launches["prop"], prop_err, times["prop"]),
            ("hy_jet_rolled_f64", *rolled),
            ("hy_phase_f64", *phased),
            ("hy_phase_f32", *f32_row),
            *convs, proto]
    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name],
             replaces=REPLACES[name], launches=n, max_abs_err=err, **tm)
        for name, n, err, tm in rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def rolled_route(sys_, ics, kw, st_fused, dev):
    """The same lanes and horizon as phase 5 through the rolled route
    (kernel B3 and the per-step driver: ``ROLLED_MIN_WIDTH`` lowered below
    the tape's width while the integrators are built), after phase 5's
    launch counts were read: its lane-steps/s beside the fused B1 route's
    (ROADMAP A.16); every lane lands on the target and the states agree
    with the fused route's to ``REF_RTOL``."""
    from heyoka_tpu_torch.taylor import batch as tbatch
    min_width = tbatch.ROLLED_MIN_WIDTH
    tbatch.ROLLED_MIN_WIDTH = 0
    try:
        warm = ht.taylor_adaptive_batch(sys_, ics[:CHUNK], device=dev, **kw)
        tr = ht.taylor_adaptive_batch(sys_, ics, device=dev, **kw)
    finally:
        tbatch.ROLLED_MIN_WIDTH = min_width
    check(tr.engine_report()["jet"] in ("hy_jet_rolled_f64",
                                         "jet_rolled_plain"),
          "phase 5: the rolled route did not take B3")
    warm.propagate_until(1.0)
    n0 = jk.LAUNCHES["jet_rolled"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oc, _, _, nsteps = tr.propagate_until(T_END)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(o == ht.TaylorOutcome.time_limit for o in oc)
          and bool((tr.time == T_END).all()),
          "phase 5, rolled route: a lane did not land on the target")
    rel = float(np.abs(tr.state - st_fused).max() / np.abs(st_fused).max())
    check(rel <= REF_RTOL, f"phase 5, rolled route vs fused: {rel}")
    steps = int(nsteps.sum())
    return dict(wall_s=wall, lane_steps=steps, steps_per_s=steps / wall,
                b3_launches=jk.LAUNCHES["jet_rolled"] - n0,
                max_rel_vs_fused=rel)


def mid_width(dev):
    """Phase 8 on mascon-32 (597 columns: the rolled route, as
    ``ROLLED_MIN_WIDTH`` is 512), after the main path's launch counts were
    read: ``mascon_lanes``' 1,024 lanes over two orbits through B3 on the
    block it chooses for the tape and the per-step driver, every lane on
    the target; then the same lanes through the fused route, held to the
    rolled route's states.  Their lane-steps/s side by side are ROADMAP
    A.16's pair at mid width."""
    kw, rng = mascon_body(MID_N)
    orbits = mascon_lanes(rng, MASCON_B, kw["omega"])
    sys_ = ht.models.mascon(**kw)
    ta = ht.taylor_adaptive_batch(sys_, orbits, device=dev, tol=TOL,
                                  high_accuracy=True)
    eng = ta.engine_report()
    check(eng["jet"] == "hy_jet_rolled_f64",
          f"mascon-{MID_N}: not the rolled route: {eng}")
    n0 = jk.LAUNCHES["jet_rolled"]
    ta.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oc, _, _, nsteps = ta.propagate_until(MASCON_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(o == ht.TaylorOutcome.time_limit for o in oc)
          and bool((ta.time == MASCON_T).all()),
          f"mascon-{MID_N}: a lane did not land on the target")
    j0, j1 = (jacobi(torch.as_tensor(x, device=dev), kw)
              for x in (orbits, ta.state))
    steps = int(nsteps.sum())
    r_end = np.linalg.norm(ta.state[:, :3], axis=1)
    # the 32 mascons' lumpy field scatters some of these lanes toward the
    # body or away from it, and their many small steps keep the driver
    # running: the drift is reported, and the fused route holds the states
    return dict(n_mascons=MID_N, W=ta._jtape.width, layout=eng["layout"],
                wall_s=wall, lane_steps=steps, steps_per_s=steps / wall,
                max_steps_per_lane=int(np.max(nsteps)),
                b3_launches=jk.LAUNCHES["jet_rolled"] - n0,
                jacobi_drift_max_rel=float(((j1 - j0).abs() / j0.abs()).max()),
                r_end_range=[float(r_end.min()), float(r_end.max())],
                fused_route=fused_route(sys_, orbits, ta.state, dev))


def fused_route(sys_, orbits, st_rolled, dev, t_end=MASCON_T, what="phase 8"):
    """The rolled route's lanes and horizon (phase 8's; phase 23 (b)'s)
    through the fused route (kernel B1 on the layout the tape takes, B2
    for the first step and the landing: ``ROLLED_MIN_WIDTH`` raised above
    the tape's width while the integrators are built), after the rolled
    route's launch counts were read: its lane-steps/s beside the rolled
    route's (ROADMAP A.16); every lane lands on the target and the states
    agree with the rolled route's to ``REF_RTOL``."""
    from heyoka_tpu_torch.taylor import batch as tbatch
    min_width = tbatch.ROLLED_MIN_WIDTH
    tbatch.ROLLED_MIN_WIDTH = 1 << 30
    kw = dict(tol=TOL, high_accuracy=True)
    try:
        warm = ht.taylor_adaptive_batch(sys_, orbits[:8], device=dev, **kw)
        tf = ht.taylor_adaptive_batch(sys_, orbits, device=dev, **kw)
    finally:
        tbatch.ROLLED_MIN_WIDTH = min_width
    eng = tf.engine_report()
    check(eng["propagate_engine"] == "fused",
          f"{what}: not the fused route: {eng}")
    warm.propagate_until(1.0)
    n0 = dict(jk.LAUNCHES)
    tf.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oc, _, _, nsteps = tf.propagate_until(t_end)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(o == ht.TaylorOutcome.time_limit for o in oc)
          and bool((tf.time == t_end).all()),
          f"{what}, fused route: a lane did not land on the target")
    rel = float(np.abs(tf.state - st_rolled).max()
                / np.abs(st_rolled).max())
    check(rel <= REF_RTOL, f"{what}, fused route vs rolled: {rel}")
    steps = int(nsteps.sum())
    return dict(wall_s=wall, lane_steps=steps, steps_per_s=steps / wall,
                launches={k: jk.LAUNCHES[k] - n0[k] for k in ("jet", "prop")},
                max_rel_vs_rolled=rel, layout=eng["layout"])


def block_shapes(tape, st, pars, aux, auxi, jet_ref, prop_ref):
    """B2 and a 64-step B1 chunk at every block shape of ``SWEEP_LANES`` x
    ``SWEEP_THREADS`` with the jets in shared memory that a block holds:
    each shape computes every item the same way, so its outputs must equal
    the default shape's (``jet_ref``, ``prop_ref``) bit for bit.  Returns
    the times with the blocks an SM holds by the rule and by the runtime,
    the fastest shape by B1's time, and the rule's shape."""
    B, dev = st.shape[1], st.device
    per = jk.lane_bytes(tape.width, tape.order)
    res = {}
    for L in SWEEP_LANES:
        for nt in SWEEP_THREADS:
            if L * per > jk.SMEM_MAX:
                continue

            def jet_run():
                return jk._jet_cuda(tape, st, pars, None, L, nt)

            def prop_run():
                return jk._prop_cuda(tape, st, pars, aux, auxi, CHUNK, True,
                                     L, nt)

            same = all(torch.equal(a, b) for a, b in zip(
                (*jet_run(), *prop_run()), (*jet_ref, *prop_ref)))
            check(same, f"B1/B2 with {L} lanes x {nt} threads differ from "
                  "the default block shape")
            sh = jk.launch_shape(tape, B, dev, L, nt)
            res[f"{L}x{nt}"] = dict(
                jet_ms=cuda_ms(jet_run, 3), prop_ms=cuda_ms(prop_run, 2),
                launch_smem_bytes=sh.smem, tables=sh.tables,
                blocks_per_sm=sh.blocks_per_sm,
                occupancy=jk.occupancy(L, nt, sh.smem), waves=sh.waves)
    rule = jk.launch_shape(tape, B, dev)
    return dict(B=B, W=tape.width, rows=tape.pass_rows, times=res,
                fastest_prop=min(res, key=lambda c: res[c]["prop_ms"]),
                fastest_jet=min(res, key=lambda c: res[c]["jet_ms"]),
                chosen=f"{rule.lanes}x{rule.threads}")


def shape_sweep(name, dev, B=B_MAIN, twins=False):
    """:func:`block_shapes` on the ``"hh"`` or ``"nbody3"`` tape at order
    19 on ``B`` lanes, every lane free for the whole chunk, against the
    rule's shape; with ``twins``, the rule's shape first against the plain
    twins (:func:`jet_parity`: ``JET_RTOL`` a lane's norm, ``PROP_RTOL``).
    Not on the 3-body lanes: their order-18 and -19 norms span 1e-15 to
    7e-7, and a 1e-16 relative change of the state moves them up to 7e-11,
    more than ``JET_RTOL`` in any order of f64 operations."""
    f64 = dict(dtype=torch.float64, device=dev)
    sys_, ics = {
        "hh": lambda: (hh_sys()[0], hh_lanes(B)),
        "nbody3": lambda: (nbody(3, masses=[1.0, 1e-3, 2e-3]),
                           NBODY3_IC + 0.01 * np.random.default_rng(
                               2).standard_normal((B, 18))),
    }[name]()
    order = taylor_order_from_tol(TOL)
    tape = jk.JetTape(ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(sys_), order)), dev)
    rule = jk.launch_shape(tape, B, dev)
    parity = jet_parity(tape, ics, dev, what=f"the {name} tape at {B} lanes "
                        f"({rule.lanes} x {rule.threads})") if twins else None
    st = torch.as_tensor(ics.T.copy(), **f64)
    pars = torch.zeros((0, B), **f64)
    aux = torch.stack([torch.full((B,), float("inf"), **f64),
                       torch.ones(B, **f64), torch.full((B,), FAR, **f64),
                       torch.zeros(B, **f64), torch.ones(B, **f64)])
    auxi = torch.full((1, B), 2**31 - 1, dtype=torch.int32, device=dev)
    res = block_shapes(tape, st, pars, aux, auxi, jk.jet(tape, st, pars),
                       jk.prop(tape, st, pars, aux, auxi, CHUNK))
    if parity:
        res.update(jet_max_rel_per_order=parity["jet"]["max_rel_per_order"],
                   norms_max_rel=parity["jet"]["norms_max_rel"],
                   prop_state_max_rel=parity["prop"]["state_max_rel"])
    return res


def huge_tapes(dev, order, smi):
    """Phases 7-9, the huge-tape path: kernel B3 against its twin and B2,
    the mascon-512 slice, and the jets' times.  Returns B3's launches in
    the slice, its largest abs error against the twin and its times, and
    the slice's wall time and lane-steps/s."""
    f64 = dict(dtype=torch.float64, device=dev)
    kw, rng = mascon_body(MASCON_N)
    ics = mascon_lanes(rng, MASCON_B)
    orbits = mascon_lanes(mascon_body(MASCON_N)[1], MASCON_B, kw["omega"])
    rtape, dtape = mascon_tapes(kw, order, dev)

    def jet_args(st):
        B = st.shape[0]
        return (torch.as_tensor(st.T.copy(), device=dev),
                torch.zeros((0, B), **f64), torch.zeros(B, **f64))

    # -- 7. B3 against jet_rolled_plain and B2 --------------------------------
    args = jet_args(ics[:B_CHECK])
    tc_k, nrm_k = jr.jet_rolled(rtape, *args)
    torch.cuda.synchronize()
    tc_p, nrm_p = jr.jet_rolled_plain(rtape, *args)
    tc_2, nrm_2 = jk.jet(dtape, *args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(tc_k).all()), "B3: non-finite coefficients")
    rel = {}
    for ref, (tc_r, nrm_r) in (("plain", (tc_p, nrm_p)),
                               ("b2", (tc_2, nrm_2))):
        rel[ref] = float(per_order_rel(tc_k, tc_r).max())
        nrel = float(((nrm_k - nrm_r).abs() / nrm_r.abs()).max())
        check(rel[ref] <= JET_RTOL and nrel <= JET_RTOL,
              f"B3 vs {ref}: per-order {rel[ref]}, norms {nrel}")
    rolled_err = float((tc_k - tc_p).abs().max())
    # mascon-512's lane takes a block's shared memory but leaves it alone on
    # its SM, so B3 runs it on the global layout; the same lanes on the
    # smem layout, forced
    rep = jr.layout_report(rtape)
    check(rep["layout"] == "global", f"mascon-512: B3 layout {rep}")
    tc_s, nrm_s = jr._jet_rolled_cuda(rtape, *args, layout="smem")
    torch.cuda.synchronize()
    s_rel = float(per_order_rel(tc_s, tc_p).max())
    s_nrel = float(((nrm_s - nrm_p).abs() / nrm_p.abs()).max())
    check(s_rel <= JET_RTOL and s_nrel <= JET_RTOL,
          f"B3 (smem layout) vs plain: per-order {s_rel}, norms {s_nrel}")
    rolled_err = max(rolled_err, float((tc_s - tc_p).abs().max()))
    WH, WC, WV, NA, NS = rtape.sizes
    say(7, B=B_CHECK, order=order, W=rtape.width,
        classes=dict(history_rows=WH, aliases=NA, C=WC, V=WV, S=NS),
        layout=rep, traffic_per_lane_jet=rl.rolled_traffic(rtape),
        vs_plain_max_rel_per_order=rel["plain"],
        vs_b2_max_rel_per_order=rel["b2"], max_abs_err=rolled_err,
        smem_layout=dict(max_rel_per_order=s_rel, norms_max_rel=s_nrel,
                         equal_to_global=bool(torch.equal(tc_s, tc_k))),
        b2_layout=jk.layout_report(dtape),
        equal_to_plain=bool(torch.equal(tc_k, tc_p)
                            and torch.equal(nrm_k, nrm_p)),
        equal_to_b2=bool(torch.equal(tc_k, tc_2)), tol=JET_RTOL)

    # -- 8. the slice: mascon-512 at 1,024 lanes ------------------------------
    sys_ = ht.models.mascon(**kw)
    ta = ht.taylor_adaptive_batch(sys_, orbits, device=dev, tol=TOL,
                                  high_accuracy=True)
    eng = ta.engine_report()
    check(eng["jet"] == "hy_jet_rolled_f64"
          and eng["propagate_engine"] == "flat",
          f"mascon-512: not the rolled route: {eng}")
    j0 = jacobi(torch.as_tensor(orbits, device=dev), kw)
    torch.cuda.synchronize()
    zero_launches()
    ta.step()
    t0 = time.perf_counter()
    oc, _, _, nsteps = ta.propagate_until(MASCON_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(jk.LAUNCHES)
    check(launches["jet_rolled"] > 0 and launches["jet"] == 0
          and launches["prop"] == 0,
          f"mascon-512: kernels launched {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in oc),
          "mascon-512: an outcome is not time_limit")
    check(bool((ta.dtime[0] == MASCON_T).all()
               and (ta.time == MASCON_T).all()),
          "mascon-512: a lane did not land on the target exactly")
    st_end = ta.state
    check(st_end.shape == (MASCON_B, 6) and bool(np.isfinite(st_end).all()),
          "mascon-512: bad final state")
    j1 = jacobi(torch.as_tensor(st_end, device=dev), kw)
    drift = float(((j1 - j0).abs() / j0.abs()).max())
    check(drift <= JACOBI_MAX, f"mascon-512: Jacobi drift {drift}")
    ref = ht.taylor_adaptive_batch(sys_, orbits[:MASCON_REF_LANES],
                                   device="cpu", tol=TOL, high_accuracy=True)
    ref.step()
    ref_oc = ref.propagate_until(MASCON_T)[0]
    ref_rel = float(np.abs(st_end[:MASCON_REF_LANES] - ref.state).max()
                    / np.abs(ref.state).max())
    check(ref_oc == oc[:MASCON_REF_LANES] and ref_rel <= REF_RTOL,
          f"mascon-512 vs the CPU run: {ref_rel}")
    steps = int(nsteps.sum())
    fused = fused_route(sys_, orbits, st_end, dev)
    say(8, B=MASCON_B, n_mascons=MASCON_N, t_end=MASCON_T, wall_s=wall,
        lane_steps=steps, steps_per_s=steps / wall,
        mean_steps_per_lane=steps / MASCON_B, launches=launches,
        jacobi_drift_max_rel=drift, cpu_ref_max_rel=ref_rel,
        r_end_range=[float(np.linalg.norm(st_end[:, :3], axis=1).min()),
                     float(np.linalg.norm(st_end[:, :3], axis=1).max())],
        engine=eng, fused_route=fused, mid_width=mid_width(dev))
    until = dict(wall_s=wall, lane_steps=steps, steps_per_s=steps / wall)

    # -- 9. times: B3, its twin and B2 at 1,024 lanes -------------------------
    args = jet_args(ics)
    runs = {"b3": lambda: jr.jet_rolled(rtape, *args),
            "plain": lambda: jr.jet_rolled_plain(rtape, *args),
            "b2": lambda: jk.jet(dtape, *args)}
    t = {name: [] for name in runs}
    for name in ("plain", "b2", "b3", "b3", "b2", "plain"):
        t[name].append(cuda_ms(runs[name], 3 if name == "b3" else 1))
    tc_k, nrm_k = runs["b3"]()
    tc_p, _ = runs["plain"]()
    rel_m = float(per_order_rel(tc_k, tc_p).max())
    check(rel_m <= JET_RTOL, f"B3 vs jet_rolled_plain at B={MASCON_B}")
    bnd = rl.bound(rl.jet_flops(rtape.arrays) * MASCON_B,
                   rl.nbytes(*args, rtape.ritab, rtape.rdtab, tc_k, nrm_k),
                   torch.float64)
    rolled_err = max(rolled_err, float((tc_k - tc_p).abs().max()))
    # B3 at each block size on both layouts: the same items computed
    # alike, so the same bits as the default launch
    shapes = {}
    for nt in jr.BLOCK_THREADS:
        for lay in ("smem", "global"):
            def run():
                return jr._jet_rolled_cuda(rtape, *args, threads=nt,
                                           layout=lay)
            check(all(torch.equal(a, b) for a, b in zip(run(),
                                                         (tc_k, nrm_k))),
                  f"B3 with {nt} threads on {lay} differs from the default")
            shapes[f"{lay}x{nt}"] = [cuda_ms(run, 3) for _ in range(2)]
    fastest = min(shapes, key=lambda k: sum(shapes[k]))
    # B2 against B3 on narrower tapes: where the rolled jet starts to pay
    sweep = {}
    tapes = {f"mascon{n}": mascon_tapes(mascon_body(n)[0], order, dev)
             for n in SWEEP_N}
    plan = build_plan(ht.taylor_decompose_sys(
        nbody(6, masses=MASSES, Gconst=GCONST)), order)
    ss = ht.plan_to_arrays(plan)
    tapes["outer_ss"] = (jr.RolledTape(ss, dev), jk.JetTape(ss, dev))
    for name, (rt, dtp) in tapes.items():
        if name == "outer_ss":
            st = lanes(IC, MASCON_B, 3)
        else:
            st = mascon_lanes(np.random.default_rng(1), MASCON_B)
        a = jet_args(st)
        b2 = [cuda_ms(lambda: jk.jet(dtp, *a), 1)]
        b3 = [cuda_ms(lambda: jr.jet_rolled(rt, *a), 3) for _ in range(2)]
        b2.append(cuda_ms(lambda: jk.jet(dtp, *a), 1))
        r = float(per_order_rel(jr.jet_rolled(rt, *a)[0],
                                jk.jet(dtp, *a)[0]).max())
        check(r <= JET_RTOL, f"B3 vs B2 on {name}: {r}")
        b3_rep = jr.layout_report(rt)
        sweep[name] = dict(W=rt.width, b2_ms=b2, b3_ms=b3,
                           b2_over_b3=(sum(b2) / 2) / (sum(b3) / 2),
                           b2_layout=jk.layout_report(dtp),
                           b3_shape=f"{b3_rep['layout']}x{b3_rep['threads']}")
    # B2 on the global layout against its twin (mascon-128)
    gtape = tapes["mascon128"][1]
    check(jk.layout_report(gtape)["layout"] == "global",
          "mascon-128: B2 not on the global layout")
    a = jet_args(mascon_lanes(np.random.default_rng(2), MASCON_B))
    (g_k, gn_k), (g_p, gn_p) = jk.jet(gtape, *a), jk.jet_plain(gtape, *a)
    g_rel = float(per_order_rel(g_k, g_p).max())
    g_nrel = float(((gn_k - gn_p).abs().amax(1) / gn_p.abs().amax(1)).max())
    check(g_rel <= JET_RTOL and g_nrel <= JET_RTOL,
          f"B2 (global layout) vs jet_plain on mascon-128: {g_rel}, {g_nrel}")
    say(9, B=MASCON_B, nvidia_smi=smi, b3_ms_runs=t["b3"],
        plain_ms_runs=t["plain"], b2_ms_runs=t["b2"],
        b3_vs_plain_max_rel_per_order=rel_m, b3_bound=bnd,
        b3_shapes_ms=shapes, b3_fastest=fastest,
        b3_chosen=f"{rep['layout']}x{rep['threads']}", sweep=sweep,
        b2_global_vs_plain=dict(tape="mascon128", max_rel_per_order=g_rel,
                                norms_max_rel=g_nrel, tol=JET_RTOL))
    return (launches["jet_rolled"], rolled_err, dict(
        timed(t["b3"], t["plain"], bnd), layout=rep["layout"],
        smem_bytes=rep["smem_bytes"], threads=rep["threads"])), until


def pendulum_energy(st):
    """``models.pendulum_energy`` at g = 9.8, l = m = 1, per lane."""
    return 0.5 * st[:, 1] * st[:, 1] + 9.8 * (1.0 - torch.cos(st[:, 0]))


def lane_tensors(st, pars, t, dev, dtype=torch.float64):
    """Lanes as :func:`phase_lanes` gives them -> the jets' arguments
    ``(state (n, B), pars (n_pars, B), t (B,))`` of ``dtype`` on ``dev``."""
    f = dict(dtype=dtype, device=dev)
    return (torch.as_tensor(st.T.copy(), **f),
            torch.as_tensor(pars.T.copy(), **f), torch.as_tensor(t, **f))


def seeded_buffer(tape, st, pars, t, dev, dtype=torch.float64):
    """The ``(K+1, W, B)`` buffer of ``dtype`` with order 0 of every column
    and the virtual columns seeded: what kernel B4 starts from."""
    tc = jk._seed_plain(tape, *lane_tensors(st, pars, t, dev, dtype))
    jp.order0(tape, tc)
    return tc


def phase_tapes(dev, order, smi):
    """Phases 10-12, the phase route: kernel B4 against its twin on every
    tape, the pendulum slice, and the times.  Returns B4's launches in
    the slice, its largest abs error against the twin and its times, and
    the slice's wall time and lane-steps/s."""
    def rel(a, b):  # (K+1, W, B) buffers, per order
        return per_order_rel(a.permute(1, 0, 2), b.permute(1, 0, 2))

    # -- 10. B4 against phase_plain on every tape -----------------------------
    cases = phase_cases(ht)
    tapes, ops, res, phase_err = {}, set(), {}, 0.0
    for i, (name, (sys_, st0, pars)) in enumerate(cases.items()):
        plan = build_plan(ht.taylor_decompose_sys(sys_), order)
        ops |= {g.name for lv in plan.levels for g in lv}
        tape = tapes[name] = jp.PhaseTape(ht.plan_to_arrays(plan), dev)
        tc0 = seeded_buffer(tape, *phase_lanes(st0, pars, PHASE_B, 10 + i),
                            dev)
        tc_p = jp.phase_plain(tape, tc0.clone(), 1)
        tc_k = jp.phase(tape, tc0.clone(), 1)
        # from lo = 9: the orders below from the twin, the rest NaN in
        # every column the kernel must write
        n_w = tape.n_eq + int(tape.arrays["arg_ptr"].size) - 1
        tc9_in = tc_p.clone()
        tc9_in[PHASE_LO:, :n_w] = float("nan")
        tc9 = jp.phase(tape, tc9_in.clone(), PHASE_LO)
        torch.cuda.synchronize()
        # every block shape and layout B4 takes, forced: each computes
        # every item alike, so each equals the default launch bit for bit
        shapes = jp.sweep_shapes(tape, 8)
        for lay, L, nt in shapes:
            for lo, src, ref in ((1, tc0, tc_k), (PHASE_LO, tc9_in, tc9)):
                check(torch.equal(jp._phase_cuda(tape, src.clone(), lo, L, nt,
                                                 lay), ref),
                      f"B4 on {name} from lo = {lo} with {L} lanes x {nt} "
                      f"threads on {lay} differs from the default")
        r = {}
        for key, tc in (("lo1", tc_k), ("lo9", tc9)):
            check(bool(torch.isfinite(tc).all()),
                  f"B4 on {name} from {key}: non-finite coefficients")
            r[key] = float(rel(tc, tc_p).max())
            nk, npl = jk._norms(tape, tc), jk._norms(tape, tc_p)
            r[key + "_norms"] = float(((nk - npl).abs().amax(1)
                                       / npl.abs().amax(1)).max())
            phase_err = max(phase_err, float((tc - tc_p).abs().max()))
        check(max(r.values()) <= JET_RTOL,
              f"B4 vs phase_plain on {name}: {r}")
        res[name] = dict(W=tape.width, shape=jp.layout_report(tape, PHASE_B),
                         shapes_equal=len(shapes), **r)
    # the series opcode's rows come from kernel S1's buffer: phase 24 (b)
    # holds B4 with them against its twin; the data-driven ops read
    # tables and side rows: phase 25 (b) holds B4 with them
    missing = sorted(set(ht.PHASE_OPS) - ops - {
        "trigseries", "interp", "interp_p", "dayfrac"})
    check(not missing, f"phase 10 ran no tape with {missing}")
    say(10, B=PHASE_B, order=order, lo=[1, PHASE_LO], tol=JET_RTOL,
        opcodes=sorted(ops, key=ht.OPCODES.index), max_rel_per_order=max(
            max(v["lo1"], v["lo9"]) for v in res.values()),
        max_abs_err=phase_err, tapes=res)

    # -- 11. the slice: the pendulum at 10,240 lanes --------------------------
    sys_ = ht.models.pendulum()
    ics = pendulum_lanes(PEND_B, 0)
    kw = dict(tol=TOL, high_accuracy=True)
    warm = ht.taylor_adaptive_batch(sys_, ics[:CHUNK], device=dev, **kw)
    warm.propagate_until(1.0)
    ta = ht.taylor_adaptive_batch(sys_, ics, device=dev, **kw)
    eng = ta.engine_report()
    check(eng == dict(device=str(dev), jet="hy_phase_f64",
                      propagate_engine="flat", prop=None, grid_engine="flat",
                      c_output_engine="flat", layout=None),
          f"pendulum: not the phase route: {eng}")
    e0 = pendulum_energy(torch.as_tensor(ics, device=dev))
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    oc, _, _, nsteps = ta.propagate_until(PEND_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(jk.LAUNCHES)
    check(launches["phase"] > 0 and all(
        n == 0 for k, n in launches.items() if k != "phase"),
        f"pendulum: kernels launched {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in oc),
          "pendulum: an outcome is not time_limit")
    check(bool((ta.dtime[0] == PEND_T).all() and (ta.time == PEND_T).all()),
          "pendulum: a lane did not land on the target exactly")
    st_end = ta.state
    check(st_end.shape == (PEND_B, 2) and bool(np.isfinite(st_end).all()),
          "pendulum: bad final state")
    e1 = pendulum_energy(torch.as_tensor(st_end, device=dev))
    drift = float(((e1 - e0).abs() / e0.abs()).max())
    check(drift <= DRIFT_MAX, f"pendulum: energy drift {drift}")
    ref = ht.taylor_adaptive_batch(sys_, ics[:REF_LANES], device="cpu", **kw)
    ref_oc = ref.propagate_until(PEND_T)[0]
    ref_rel = float(np.abs(st_end[:REF_LANES] - ref.state).max()
                    / np.abs(ref.state).max())
    check(ref_oc == oc[:REF_LANES] and ref_rel <= REF_RTOL,
          f"pendulum vs the CPU run: {ref_rel}")
    steps = int(nsteps.sum())
    # the first PROFILE_T of the run again, timed without and then with
    # the profiler: the device's busy time by kernel over the host's wall
    from torch.profiler import ProfilerActivity, profile
    tw = ht.taylor_adaptive_batch(sys_, ics, device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tw.propagate_until(PROFILE_T)
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    tp = ht.taylor_adaptive_batch(sys_, ics, device=dev, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tp.propagate_until(PROFILE_T)
        torch.cuda.synchronize()
    dev_ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e6
    b4 = sum(e.time_range.elapsed_us() for e in dev_ev
             if "phase_kernel" in e.name) / 1e6
    say(11, B=PEND_B, t_end=PEND_T, wall_s=wall, lane_steps=steps,
        steps_per_s=steps / wall, mean_steps_per_lane=steps / PEND_B,
        launches=launches, energy_drift_max_rel=drift,
        cpu_ref_max_rel=ref_rel, engine=eng, profile_t_end=PROFILE_T,
        profile_wall_s=wall_w, device_events=len(dev_ev),
        device_busy_s=busy if dev_ev else None,
        device_idle_share=1.0 - busy / wall_w if dev_ev else None,
        b4_share_of_busy=b4 / busy if dev_ev else None)
    until = dict(wall_s=wall, lane_steps=steps, steps_per_s=steps / wall)

    # -- 12. times: B4 against phase_plain, per block shape -------------------
    widest = max((n for n in cases if not n.startswith("op_")
                  and n != "pendulum"), key=lambda n: tapes[n].width)
    ss_plan = proto_phase.outer_ss_plan(order)
    tapes["outer_ss"] = jp.PhaseTape(ht.plan_to_arrays(ss_plan), dev)
    runs = {}
    for name, B, lo, seed in (("pendulum", PEND_B, 1, 3),
                              (widest, PHASE_B, 1, 4),
                              ("outer_ss", B_MAIN, PHASE_LO, 0)):
        tape = tapes[name]
        jargs = None
        if name == "outer_ss":  # phase 14's buffer, in f64
            tc0 = proto_phase.realistic_buffer(
                ss_plan, IC, B, lo, dev, seed).permute(1, 0, 2).contiguous(
                ).double()
        else:
            if name == "pendulum":
                lanes_ = (pendulum_lanes(B, seed), np.zeros((B, 0)),
                          np.zeros(B))
            else:
                lanes_ = phase_lanes(cases[name][1], cases[name][2], B, seed)
            tc0 = seeded_buffer(tape, *lanes_, dev)
            jargs = lane_tensors(*lanes_, dev)
        tck, tcp = tc0.clone(), tc0.clone()
        t = {"kernel": [], "plain": []}
        # the kernel's runs replayed from a CUDA graph: a pendulum jet
        # takes about as long as its launch from Python
        for which in ("plain", "kernel", "kernel", "plain"):
            if which == "kernel":
                t[which].append(graph_ms(lambda: jp.phase(tape, tck, lo), 10))
            else:
                t[which].append(cuda_ms(
                    lambda: jp.phase_plain(tape, tcp, lo), 1))
        r = float(rel(tck, tcp).max())
        check(r <= JET_RTOL, f"B4 vs phase_plain on {name} at B={B}: {r}")
        phase_err = max(phase_err, float((tck - tcp).abs().max()))
        ms = sum(t["kernel"]) / 2
        # every shape and layout, forced, each equal to the default bit for
        # bit; the staging alone (rows in and back, no pass; it leaves the
        # orders it would write undefined, hence a scratch buffer)
        shapes = {}
        for lay, L, nt in jp.sweep_shapes(tape, 8):
            got = jp._phase_cuda(tape, tc0.clone(), lo, L, nt, lay)
            check(torch.equal(got, tck), f"B4 on {name} at B={B} with {L} "
                  f"lanes x {nt} threads on {lay} differs from the default")
            shapes[f"{lay}:{L}x{nt}"] = graph_ms(
                lambda: jp._phase_cuda(tape, tck, lo, L, nt, lay), 5)
        shape = jp.layout_report(tape, B)
        stage = None
        if shape["layout"] == "smem":
            scratch = tc0.clone()
            stage = graph_ms(lambda: jp.stage(tape, scratch, lo), 10)
        runs[name] = dict(
            B=B, W=tape.width, lo=lo, ms_runs=t["kernel"],
            plain_ms_runs=t["plain"], max_rel_per_order=r, shape=shape,
            stage_ms=stage, stage_share=None if stage is None else stage / ms,
            shapes_ms=shapes, fastest=min(shapes, key=shapes.get),
            jet_phase_ms=None if jargs is None else cuda_ms(
                lambda: jp.jet_phase(tape, *jargs), 3))
        runs[name].update(rl.bound(
            rl.phase_flops(tape.arrays, lo) * B,
            rl.phase_bytes(tape.arrays, B, lo, 8)
            + rl.nbytes(tape.itab, tape.dtab), torch.float64))
    say(12, nvidia_smi=smi, **runs)
    tm = runs["pendulum"]
    return (launches["phase"], phase_err, dict(
        timed(tm["ms_runs"], tm["plain_ms_runs"], tm),
        **{k: tm["shape"][k] for k in ("layout", "lanes", "threads",
                                       "smem")})), until


def zero_launches():
    for k in jk.LAUNCHES:
        jk.LAUNCHES[k] = 0


def timed_call(make, call):
    """``call(make())``, the call between two device syncs: (integrator,
    result, wall seconds)."""
    ta = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = call(ta)
    torch.cuda.synchronize()
    return ta, res, time.perf_counter() - t0


def lane_rates(runs):
    """Lane-steps/s of ``(result, wall)`` pairs (``nsteps`` at index 3)."""
    return [int(r[3].sum()) / w for r, w in runs]


def grid_run(name, sys_, ics, grid, kernel, dev, ref_lanes):
    """``propagate_grid(grid)`` on ``ics`` at full width through the
    per-step driver over ``kernel`` (a ``LAUNCHES`` key; the counts set to
    0 just before the run and read just after): only that kernel, every
    lane ``time_limit``, finite rows, and ``ref_lanes`` lanes equal to the
    port's CPU run to ``GRID_RTOL``.  Timed beside ``propagate_until`` to
    the grid's end on the same lanes, in turns (until, grid, grid, until;
    a fresh integrator each).  Returns the checked run's integrator and
    rows (B, len(grid), n), and the summary."""
    kw = dict(tol=TOL, high_accuracy=True)
    ht.taylor_adaptive_batch(sys_, ics[:CHUNK], device=dev, **kw
                             ).propagate_grid(grid[:3])

    def make():
        return ht.taylor_adaptive_batch(sys_, ics, device=dev, **kw)

    def until(ta):
        return ta.propagate_until(grid[-1])

    def on_grid(ta):
        return ta.propagate_grid(grid)

    runs = {"until": [timed_call(make, until)[1:]]}
    zero_launches()
    ta, res, wall = timed_call(make, on_grid)
    launches = dict(jk.LAUNCHES)
    oc, out = res[0], res[4]
    check(launches[kernel] > 0 and all(
        n == 0 for k, n in launches.items() if k != kernel),
        f"{name} grid: kernels launched {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in oc),
          f"{name} grid: an outcome is not time_limit")
    check(out.shape == (len(ics), len(grid), ta.dim)
          and bool(np.isfinite(out).all()), f"{name} grid: bad rows")
    runs["grid"] = [(res, wall), timed_call(make, on_grid)[1:]]
    runs["until"].append(timed_call(make, until)[1:])
    ref = ht.taylor_adaptive_batch(sys_, ics[:ref_lanes], device="cpu", **kw)
    rc = ref.propagate_grid(grid)
    ref_rel = float(np.abs(out[:ref_lanes] - rc[4]).max()
                    / np.abs(rc[4]).max())
    check(rc[0] == oc[:ref_lanes] and ref_rel <= GRID_RTOL,
          f"{name} grid vs the CPU run: {ref_rel}")
    return ta, out, dict(
        B=len(ics), n_grid=len(grid), t_end=float(grid[-1]),
        lane_steps=int(res[3].sum()), wall_s=[w for _, w in runs["grid"]],
        steps_per_s=lane_rates(runs["grid"]),
        until_wall_s=[w for _, w in runs["until"]],
        until_steps_per_s=lane_rates(runs["until"]), launches=launches,
        cpu_ref_lanes=ref_lanes, cpu_ref_max_rel=ref_rel,
        engine=ta.engine_report())


def drift_over_rows(inv, rows, st0, dev):
    """The largest relative change of the invariant ``inv`` (a function of
    (N, n) states on ``dev``) over every row of every lane."""
    r = torch.as_tensor(rows, device=dev)
    B, n_grid, n = r.shape
    i0 = inv(torch.as_tensor(st0, device=dev))
    i1 = inv(r.reshape(B * n_grid, n)).reshape(B, n_grid)
    return float(((i1 - i0[:, None]).abs() / i0.abs()[:, None]).max())


def grid_paths(dev, smi, sys_ss, ics_ss, st_fused, until):
    """Phase 15, ``propagate_grid`` at full width on the three routes: the
    outer SS on phase 5's lanes (B2 only; the last row equal to phase 5's
    fused landing state to ``GRID_RTOL``), mascon-512 on phase 8's (B3
    only) and the pendulum on phase 11's (B4 only); every row within
    ``DRIFT_MAX`` / ``JACOBI_MAX`` of the invariant, lanes against the CPU
    run, each route's lane-steps/s beside its ``propagate_until``'s
    (``until``); then the first tenth of the outer-SS grid without and with
    ``torch.profiler``, for the device's idle share on this route.
    Returns each route's integrator, rows, grid and launches."""
    res, out = {}, {}
    # -- the outer Solar System: kernel B2 ---------------------------------
    grid = np.linspace(0.0, T_END, GRID_N)
    ta, rows, r = grid_run("outer SS", sys_ss, ics_ss, grid, "jet", dev,
                           REF_LANES)
    last_rel = float(np.abs(rows[:, -1] - st_fused).max()
                     / np.abs(st_fused).max())
    check(last_rel <= GRID_RTOL, f"outer SS grid: last row vs phase 5 "
          f"{last_rel}")
    drift = drift_over_rows(lambda x: energy(x, MASSES, GCONST), rows,
                            ics_ss, dev)
    check(drift <= DRIFT_MAX, f"outer SS grid: energy drift {drift}")
    res["outer_ss"] = dict(r, last_row_vs_fused_max_rel=last_rel,
                           energy_drift_max_rel=drift,
                           slice_phase_5=until["outer_ss"])
    out["outer_ss"] = dict(ta=ta, rows=rows, grid=grid, sys=sys_ss,
                           ics=ics_ss, launches=r["launches"])
    # the grid's first tenth, timed three times without and then once with
    # the profiler; the idle share against the median of the three
    from torch.profiler import ProfilerActivity, profile
    short = grid[:GRID_N // 10 + 1]
    kw = dict(tol=TOL, high_accuracy=True)
    walls = [timed_call(
        lambda: ht.taylor_adaptive_batch(sys_ss, ics_ss, device=dev, **kw),
        lambda ta: ta.propagate_grid(short))[2] for _ in range(3)]
    wall_w = sorted(walls)[1]
    tp = ht.taylor_adaptive_batch(sys_ss, ics_ss, device=dev, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tp.propagate_grid(short)
        torch.cuda.synchronize()
    dev_ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e6
    b2 = sum(e.time_range.elapsed_us() for e in dev_ev
             if "jet_kernel" in e.name) / 1e6
    res["outer_ss"]["profile"] = dict(
        t_end=float(short[-1]), wall_s=walls, device_events=len(dev_ev),
        device_busy_s=busy if dev_ev else None,
        device_idle_share=1.0 - busy / wall_w if dev_ev else None,
        b2_share_of_busy=b2 / busy if dev_ev else None)

    # -- mascon-512: kernel B3 ---------------------------------------------
    kw_m, _ = mascon_body(MASCON_N)
    orbits = mascon_lanes(mascon_body(MASCON_N)[1], MASCON_B, kw_m["omega"])
    sys_m = ht.models.mascon(**kw_m)
    grid = np.linspace(0.0, MASCON_T, MASCON_GRID_N)
    ta, rows, r = grid_run("mascon-512", sys_m, orbits, grid, "jet_rolled",
                           dev, MASCON_REF_LANES)
    drift = drift_over_rows(lambda x: jacobi(x, kw_m), rows, orbits, dev)
    check(drift <= JACOBI_MAX, f"mascon-512 grid: Jacobi drift {drift}")
    res["mascon512"] = dict(r, jacobi_drift_max_rel=drift,
                            slice_phase_8=until["mascon512"])
    out["mascon512"] = dict(ta=ta, rows=rows, grid=grid, sys=sys_m,
                            ics=orbits, launches=r["launches"])

    # -- the pendulum: kernel B4 -------------------------------------------
    ics_p = pendulum_lanes(PEND_B, 0)
    grid = np.linspace(0.0, PEND_T, PEND_GRID_N)
    ta, rows, r = grid_run("pendulum", ht.models.pendulum(), ics_p, grid,
                           "phase", dev, REF_LANES)
    drift = drift_over_rows(pendulum_energy, rows, ics_p, dev)
    check(drift <= DRIFT_MAX, f"pendulum grid: energy drift {drift}")
    res["pendulum"] = dict(r, energy_drift_max_rel=drift,
                           slice_phase_11=until["pendulum"])
    out["pendulum"] = dict(ta=ta, rows=rows, launches=r["launches"])
    say(15, nvidia_smi=smi, tol=GRID_RTOL, **res)
    return out


def cout_paths(dev, smi, sys_ss, grids):
    """Phase 16, dense and continuous output: ``propagate_until(...,
    c_output=True)`` at full width on the outer SS (B2 only) and
    mascon-512 (B3 only), the counts set to 0 just before each run; the
    records' peak device memory; ``n_steps`` equal to ``nsteps``; the
    continuous output at phase 15's grid times equal to its rows to
    ``COUT_RTOL`` per lane (and whether bit for bit); timed beside
    ``propagate_until`` in turns (c_output, until, until, c_output; a
    fresh integrator each); ``update_d_output`` at mid-step after one
    ``step()`` on each route against the CPU run; a pickle round trip of
    each route's integrator on the card, then one more ``propagate_until``
    from each copy, equal bit for bit.  Returns each c_output run's
    launches."""
    kw = dict(tol=TOL, high_accuracy=True)
    res, launches_out = {}, {}
    for name, kernel in (("outer_ss", "jet"), ("mascon512", "jet_rolled")):
        g = grids[name]
        grid, rows, ics = g["grid"], g["rows"], g["ics"]

        def make():
            return ht.taylor_adaptive_batch(g["sys"], ics, device=dev, **kw)

        def cout(ta):
            return ta.propagate_until(grid[-1], c_output=True)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        zero_launches()
        ta, first, wall = timed_call(make, cout)
        launches = dict(jk.LAUNCHES)
        oc, _, _, nsteps, co = first
        check(ta.engine_report()["c_output_engine"] == "flat",
              f"{name}: c_output not on the per-step driver")
        peak = torch.cuda.max_memory_allocated(dev)
        check(launches[kernel] > 0 and all(
            n == 0 for k, n in launches.items() if k != kernel),
            f"{name} c_output: kernels launched {launches}")
        check(all(o == ht.TaylorOutcome.time_limit for o in oc),
              f"{name} c_output: an outcome is not time_limit")
        check(bool((co.n_steps == nsteps).all()),
              f"{name} c_output: n_steps differs from nsteps")
        vals = co(np.repeat(grid[:, None], len(ics), 1)).transpose(1, 0, 2)
        lane_rel = (np.abs(vals - rows).max((1, 2))
                    / np.abs(rows).max((1, 2)))
        check(float(lane_rel.max()) <= COUT_RTOL,
              f"{name}: c_output vs the grid rows {float(lane_rel.max())}")
        tcs_bytes = co._tcs.numel() * 8
        del co, first
        runs = {"c_output": [(nsteps, wall)], "until": [
            timed_call(make, lambda ta: ta.propagate_until(grid[-1]))[1:]
            for _ in range(2)]}
        _, again, w2 = timed_call(make, cout)
        runs["c_output"].append((again[3], w2))
        del again
        res[name] = dict(
            B=len(ics), t_end=float(grid[-1]),
            lane_steps=int(nsteps.sum()),
            wall_s=[w for _, w in runs["c_output"]],
            steps_per_s=[int(n.sum()) / w for n, w in runs["c_output"]],
            until_wall_s=[w for _, w in runs["until"]],
            until_steps_per_s=lane_rates(runs["until"]), launches=launches,
            records_bytes=tcs_bytes, base_bytes=base,
            peak_memory_bytes=peak, vs_grid_max_rel=float(lane_rel.max()),
            vs_grid_bit_equal=bool(np.array_equal(vals, rows)),
            vs_grid_equal_share=float((vals == rows).all(2).mean()),
            grid_lane_steps=int(sum(r[3] for r in g["ta"].get_propagate_res())),
            tol=COUT_RTOL)
        launches_out[name] = launches
        g["ta_cout"] = ta

    # update_d_output at mid-step after one step on each route, held
    # against the same lanes on the CPU
    d_out = {}
    cases = (("outer_ss", grids["outer_ss"]["sys"],
              grids["outer_ss"]["ics"][:REF_LANES]),
             ("mascon512", grids["mascon512"]["sys"],
              grids["mascon512"]["ics"][:MASCON_REF_LANES]),
             ("pendulum", ht.models.pendulum(), pendulum_lanes(REF_LANES, 0)))
    for name, sys_, st in cases:
        pair = [ht.taylor_adaptive_batch(sys_, st, device=d, **kw)
                for d in (dev, "cpu")]
        d = []
        for x in pair:
            x.step()
            d.append((x.update_d_output(x.time - x.last_h / 2),
                      x.update_d_output(x.last_h / 3, rel_time=True)))
        rel = max(float(np.abs(a - b).max() / np.abs(b).max())
                  for a, b in zip(*d))
        check(rel <= PROP_RTOL, f"{name}: d_output vs the CPU run {rel}")
        d_out[name] = dict(lanes=len(st), max_rel=rel, tol=PROP_RTOL)

    # a pickle round trip on the card, then the same propagate_until from
    # the original and the copy
    pick = {}
    for name, ta, dt in (("outer_ss", grids["outer_ss"]["ta_cout"], 10.0),
                         ("mascon512", grids["mascon512"]["ta_cout"],
                          MASCON_T / 4),
                         ("pendulum", grids["pendulum"]["ta"], 1.0)):
        cp = pickle.loads(pickle.dumps(ta))
        t1 = float(ta.time[0]) + dt
        ra, rb = ta.propagate_until(t1), cp.propagate_until(t1)
        same = (ra[0] == rb[0] and all(
            np.array_equal(a, b) for a, b in (
                (ta.state, cp.state), (ta.tc, cp.tc), (ra[3], rb[3]),
                *zip(ta.dtime, cp.dtime))))
        check(same, f"{name}: the pickled copy's propagation differs")
        pick[name] = dict(device=cp.engine_report()["device"], t_end=t1,
                          bit_equal=same)
    say(16, nvidia_smi=smi, c_output=res, d_output=d_out, pickle=pick)
    return launches_out


def tool_row(name, n, res):
    """A tool kernel's entry of the kernels' line from its ``run`` result."""
    return (name, n, res["max_abs_err"], {
        k: res.get(k) for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")})


def conv_tool(dev, smi):
    """Phase 13, the convolution microbenchmark: the tool's ``run`` (both
    kernels checked against their plain versions, else it raises; its
    ``launches``, those of its first call, outside the CUDA graphs it
    times with), each kernel equal to its plain version bit for bit and
    within its bound of f64 (f32 over 20-term sums 1e-5, two-f32 1e-12,
    relative to max(1, |c|)), then the tool's ``sweep`` (T1-dd and its
    yardstick at every tile, each equal to the rule's launch bit for bit,
    with the blocks an SM the runtime holds, at least the rule's count), the
    ring's clock trace (``trace``: per tile, waiting, reading, arithmetic)
    and T1-dd beside its parent and the predictions (PERF.md).
    Returns the kernels' rows: ``ms`` replayed from a CUDA graph,
    ``cuda_ms`` from back-to-back launches beside it."""
    zero_launches()
    res = microbench_conv.run(dev)
    launches = res["launches"]
    check(launches["conv_f32"] > 0 and launches["conv_dd"] > 0,
          f"T1: kernels launched {launches}")
    check(res["f32"]["same_bits_as_plain"] and res["dd"]["same_bits_as_plain"],
          "T1: a kernel differs from its plain version")
    check(res["f32"]["rel_err_vs_f64"] <= 1e-5
          and res["dd"]["rel_err_vs_f64"] <= 1e-12,
          f"T1 vs f64: {res['f32']['rel_err_vs_f64']}, "
          f"{res['dd']['rel_err_vs_f64']}")
    sweep = microbench_conv.sweep(dev)
    for key, sh in sweep["tiles"].items():
        check(sh["occupancy"] >= sh["blocks_per_sm"],
              f"T1-dd at tile {key}: the runtime holds {sh['occupancy']} blocks "
              f"an SM, the rule counts {sh['blocks_per_sm']}")
    dd_ms = res["dd"]["ms"]
    say(13, nvidia_smi=smi, **res, dd_sweep=sweep,
        dd_trace=microbench_conv.trace(dev), dd_vs_parent=dict(
        ms=dd_ms, parent_ms=T1_DD_PARENT_MS, bound_ms=res["dd"]["bound_ms"],
        x_bound=dd_ms / res["dd"]["bound_ms"], predictions={
            k: dict(ms=[lo, hi], hit=lo <= dd_ms <= hi)
            for k, (lo, hi) in T1_DD_PREDICTED_MS.items()}))
    rows = []
    for name, which in (("hy_conv_f32", "f32"), ("hy_conv_dd", "dd")):
        row = tool_row(name, launches[f"conv_{which}"], res[which])
        row[3].update(timer=res["timer"], cuda_ms=res[which]["cuda_ms"])
        if which == "dd":
            row[3].update(shape=res["dd_shape"],
                          direct_ms=res["dd_direct_ms"])
        rows.append(row)
    return rows


def proto_tool(dev, smi):
    """Phase 14, the f32 phase prototype: the tool's ``run`` (T2 checked
    against its plain body, else it raises; B4 in f64 from lo = 9 beside
    it), T2's orders within 1e-4 relative of B4's, per order, then the
    tool's ``sweep``.  Returns T2's row."""
    zero_launches()
    res = proto_phase.run(dev)
    launches = dict(jk.LAUNCHES)
    check(launches["proto_phase"] > 0 and launches["phase"] > 0,
          f"T2: kernels launched {launches}")
    vs64 = res["f32_vs_f64_rel_per_order"]
    check(all(np.isfinite(vs64)) and max(vs64) <= 1e-4,
          f"T2 (f32) vs B4 (f64) per order: {vs64}")
    # every forced block shape and the staging, after the path's counts
    say(14, nvidia_smi=smi, launches=launches, **res,
        **proto_phase.sweep(dev))
    name, n, err, tm = tool_row("hy_proto_phase_f32", launches["proto_phase"],
                                res)
    return name, n, err, dict(tm, **{k: res["shape"][k] for k in (
        "layout", "lanes", "threads", "smem")})


# -- events (phases 17-19) ----------------------------------------------------

HH_B = 10_240
HH_B_REF = 1_024  # the reference benchmark's width (hh_event_bench.py:53)
HH_T = 200.0
HH_REF_LANES = 64
HH_HIT_ATOL = 1e-10
HH_COUT_Y = 1e-12
HH_GRID_T = 20.0
HH_GRID_N = 201
HH_GRID_ATOL = 1e-12
TE_PEND_T = 20.0
SS_CB_STEPS = 10


def hh_sys():
    """Henon-Heiles (``benchmarks/hh_event_bench.py:14-21``) and its y."""
    x, y, px, py = ht.make_vars("x", "y", "px", "py")
    return [(x, px), (y, py), (px, -x - 2.0 * x * y),
            (py, -y - (x * x - y * y))], y


def hh_energy(st):
    """H = (px^2 + py^2)/2 + (x^2 + y^2)/2 + x^2 y - y^3/3 per lane."""
    x, y, px, py = st.unbind(1)
    return (0.5 * (px * px + py * py) + 0.5 * (x * x + y * y) + x * x * y
            - y * y * y / 3.0)


def hh_lanes(B):
    """``[0, 0.1, 0.35, 0.1] + 1e-3 N(0, 1)``, numpy rng 0
    (``hh_event_bench.py:55-58``); the first 1,024 of any B are the
    reference's lanes."""
    rng = np.random.default_rng(0)
    return (np.array([0.0, 0.1, 0.35, 0.1])[None]
            + 1e-3 * rng.standard_normal((B, 4)))


class HitArrays:
    """A vectorized non-terminal callback that keeps every hit: the arrays
    of one call an event, sorted by lane and then time."""

    vectorized = True

    def __init__(self):
        self.parts = []

    def __call__(self, tb, ts, sgn, lanes):
        self.parts.append((np.asarray(ts), np.asarray(sgn),
                           np.asarray(lanes)))

    def arrays(self):
        if not self.parts:
            return np.zeros(0), np.zeros(0, int), np.zeros(0, int)
        return tuple(np.concatenate(x) for x in zip(*self.parts))

    def per_lane(self, B):
        ts, sg, ln = self.arrays()
        return [(ts[ln == i], sg[ln == i]) for i in range(B)]


def hh_batch(ics, dev, cb=None, **kw):
    sys_, y = hh_sys()
    ev = [] if cb is None else [ht.nt_event(
        y, cb, direction=ht.EventDirection.positive)]
    return ht.taylor_adaptive_batch(sys_, ics, device=dev, tol=TOL,
                                    high_accuracy=True, nt_events=ev, **kw)


def event_rows(dev, smi, order):
    """Phase 17, the sv-func rows of B2, B3 and B4 against their plain
    versions on the card, 1e-13 relative per order (norms too): B2 on the
    Henon-Heiles tape with its event y and on the outer-SS tape with a
    close approach (Uranus and Neptune within 10 au) at 10,240 lanes, B3
    on mascon-512 with the alias-form x - 1.5 and the impact x^2 + y^2 +
    z^2 - 1 at 1,024 lanes (its layout; its bytes a lane beside the
    tape's without events and with the alias-form event alone, which
    costs its order 0, 8 bytes), B4 on the pendulum with v and x at 10,240;
    B2's bound on each of its tapes (``tools/roofline.py``, as phase 6's).
    Returns each kernel's largest error and times."""
    f64 = dict(dtype=torch.float64, device=dev)
    res, errs = {}, {}

    def compare(name, jet_fn, plain_fn, tape, args, kernel, B):
        zero_launches()
        tc, nrm = jet_fn(tape, *args)
        torch.cuda.synchronize()
        check(jk.LAUNCHES[kernel] == 1, f"{name}: {kernel} not launched")
        tc_p, nrm_p = plain_fn(tape, *args)
        rel = float(per_order_rel(tc, tc_p).max())
        nrel = float(((nrm - nrm_p).abs().amax(1)
                      / nrm_p.abs().amax(1)).max())
        check(rel <= JET_RTOL and nrel <= JET_RTOL,
              f"{name}: event rows vs plain {rel}, norms {nrel}")
        err = float((tc - tc_p).abs().max())
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        t_k = [cuda_ms(lambda: jet_fn(tape, *args), 5) for _ in range(2)]
        res[name] = dict(B=B, rows=int(tc.shape[0]), n_eq=tape.n_eq,
                         n_out=tape.n_out, max_rel_per_order=rel,
                         norms_max_rel=nrel, max_abs_err=err, ms_runs=t_k)
        if kernel == "jet":  # B2's bound with the event rows, as phase 6's
            res[name].update(rl.bound(
                B * rl.jet_flops(tape.arrays),
                rl.nbytes(*args, tape.itab, tape.dtab, tc, nrm),
                torch.float64))

    def tape_of(sys_, evs, cls):
        return cls(ht.plan_to_arrays(build_plan(
            ht.taylor_decompose_sys(sys_, extra_outputs=evs), order)), dev)

    # B2: Henon-Heiles with y, the outer SS with a close approach
    sys_h, y = hh_sys()
    st = torch.as_tensor(hh_lanes(HH_B).T.copy(), **f64)
    np0 = torch.zeros((0, HH_B), **f64)
    compare("b2_hh", jk.jet, jk.jet_plain, tape_of(sys_h, [y], jk.JetTape),
            (st, np0), "jet", HH_B)
    sys_ss = nbody(6, masses=MASSES, Gconst=GCONST)
    v = [lhs for lhs, _ in sys_ss]
    d2 = sum((v[18 + i] - v[24 + i]) ** 2 for i in range(3))
    st = torch.as_tensor(lanes(IC, B_MAIN, 3).T.copy(), **f64)
    compare("b2_outer_ss", jk.jet, jk.jet_plain,
            tape_of(sys_ss, [d2 - 100.0], jk.JetTape), (st, np0), "jet",
            B_MAIN)
    # B3: mascon-512 with an alias-form event and an impact
    kw_m, rng_m = mascon_body(MASCON_N)
    sys_m = ht.models.mascon(**kw_m)
    x, yv, z = (lhs for lhs, _ in sys_m[:3])
    evs = [x * x + yv * yv + z * z - 1.0, x - 1.5]
    tr = tape_of(sys_m, evs, jr.RolledTape)
    orbits = mascon_lanes(rng_m, MASCON_B, kw_m["omega"])
    st = torch.as_tensor(orbits.T.copy(), **f64)
    npm = torch.zeros((0, MASCON_B), **f64)
    compare("b3_mascon512", jr.jet_rolled, jr.jet_rolled_plain, tr,
            (st, npm, torch.zeros(MASCON_B, **f64)), "jet_rolled", MASCON_B)
    # bytes a lane: the alias-form event alone is an alias (its order 0,
    # 8 bytes); the impact adds the history of its new columns
    per = {k: jr.layout_report(tape_of(sys_m, e, jr.RolledTape))[
        "lane_bytes"] for k, e in (("none", []), ("alias", [x - 1.5]))}
    per["both"] = jr.layout_report(tr)["lane_bytes"]
    check(per["alias"] == per["none"] + 8,
          f"B3: the alias-form event costs {per['alias'] - per['none']} B")
    res["b3_mascon512"].update(
        layout=jr.layout_report(tr), lane_bytes=per,
        alias_events=int((tr.classv[tr.arrays["out_cols"]] == jr.A).sum()))
    # B4: the pendulum with v and x
    sys_p = ht.models.pendulum()
    xp, vp = (lhs for lhs, _ in sys_p)
    tp = tape_of(sys_p, [vp, xp], jp.PhaseTape)
    st = torch.as_tensor(pendulum_lanes(PEND_B, 1).T.copy(), **f64)
    npp = torch.zeros((0, PEND_B), **f64)

    def phase_plain_jet(tape, state, pars, t=None):
        buf = jk._seed_plain(tape, state, pars, t)
        jp.order0(tape, buf)
        jp.phase_plain(tape, buf, 1)
        return jk._rows(tape, buf), jk._norms(tape, buf)

    compare("b4_pendulum", jp.jet_phase, phase_plain_jet, tp, (st, npp),
            "phase", PEND_B)
    say(17, nvidia_smi=smi, tol=JET_RTOL, **res)
    return errs, res


def hh_poincare(dev, smi):
    """Phase 18, the Henon-Heiles Poincare batch: ``nt_event(y,
    direction=positive)`` to t = 200 at tol 1e-15 at 10,240 and 1,024
    lanes; only B2 launched on the event path, one launch a lockstep step;
    energy drift; 64 lanes' hits against the port's CPU run; at 1,024 the
    same run with ``c_output`` and y at every hit; the rates with and
    without the event (fused B1) in turns; the device idle share on a
    tenth of the run; the isolation's share of an event step.  Returns the
    summary and the 10,240-lane run's hits (``HitArrays.arrays``)."""
    out = {}
    warm = HitArrays()
    hh_batch(hh_lanes(CHUNK), dev, warm).propagate_until(1.0)
    hh_batch(hh_lanes(CHUNK), dev).propagate_until(1.0)
    for B in (HH_B, HH_B_REF):
        ics = hh_lanes(B)
        e0 = hh_energy(torch.as_tensor(ics, device=dev))
        rec = HitArrays()
        zero_launches()
        ta, res, wall = timed_call(lambda: hh_batch(ics, dev, rec),
                                   lambda t: t.propagate_until(HH_T))
        launches = dict(jk.LAUNCHES)
        oc, _, _, ns = res
        check(ta.engine_report()["propagate_engine"] == "events",
              "HH: not the event driver")
        check(launches["jet"] == int(ns.max()) and all(
            n == 0 for k, n in launches.items() if k != "jet"),
            f"HH B={B}: launches {launches}, {int(ns.max())} lockstep steps")
        check(all(o == ht.TaylorOutcome.time_limit for o in oc)
              and bool((ta.time == HH_T).all()), f"HH B={B}: landing")
        drift = float(((hh_energy(torch.as_tensor(ta.state, device=dev))
                        - e0).abs() / e0.abs()).max())
        check(drift <= DRIFT_MAX, f"HH B={B}: energy drift {drift}")
        ts, sg, ln = rec.arrays()
        check(bool((sg == 1).all()), "HH: a hit of the wrong direction")
        runs = {"events": [(res, wall)], "plain": []}
        for i, key in enumerate(("plain", "events", "plain")):
            zero_launches()
            runs[key].append(timed_call(
                lambda: hh_batch(ics, dev, HitArrays() if key == "events"
                                 else None),
                lambda t: t.propagate_until(HH_T))[1:])
            if i == 0:  # the event-free route: fused B1, B2 to land
                plain_launches = dict(jk.LAUNCHES)
                check(plain_launches["prop"] > 0,
                      f"HH without the event: launches {plain_launches}")
        rate = {k: lane_rates(v) for k, v in runs.items()}
        r = dict(B=B, t_end=HH_T, lane_steps=int(ns.sum()),
                 lockstep_steps=int(ns.max()), crossings=int(ts.size),
                 crossings_per_lane=ts.size / B, launches=launches,
                 plain_launches=plain_launches,
                 energy_drift_max_rel=drift,
                 events_wall_s=[w for _, w in runs["events"]],
                 plain_wall_s=[w for _, w in runs["plain"]],
                 events_steps_per_s=rate["events"],
                 plain_steps_per_s=rate["plain"],
                 overhead_x=float(np.median(rate["plain"])
                                  / np.median(rate["events"])))
        if B == HH_B:
            # 64 lanes against the port's CPU run
            ref = HitArrays()
            hh_batch(ics[:HH_REF_LANES], "cpu", ref).propagate_until(HH_T)
            mine = rec.per_lane(HH_REF_LANES)
            cpu = ref.per_lane(HH_REF_LANES)
            check(all(a[0].size == b[0].size and np.array_equal(a[1], b[1])
                      for a, b in zip(mine, cpu)),
                  "HH: hits differ from the CPU run in count or sign")
            dt_max = max(float(np.abs(a[0] - b[0]).max(initial=0.0))
                         for a, b in zip(mine, cpu))
            check(dt_max <= HH_HIT_ATOL, f"HH: hit times vs CPU {dt_max}")
            r.update(cpu_ref_lanes=HH_REF_LANES, cpu_ref_hit_dt_max=dt_max)
            hits = rec.arrays()
            r["isolation"] = isolation_share(
                lambda: hh_batch(ics, dev, HitArrays()), HH_T / 10)
            r["profile"] = hh_profile(ics, dev)
        else:
            # the same run with c_output: y at every hit time
            rc = HitArrays()
            zero_launches()
            tc_, resc = hh_batch(ics, dev, rc), None
            resc = tc_.propagate_until(HH_T, c_output=True)
            check(jk.LAUNCHES["jet"] > 0 and jk.LAUNCHES["prop"] == 0,
                  f"HH c_output: launches {dict(jk.LAUNCHES)}")
            co = resc[4]
            per = rc.per_lane(B)
            m = max(p[0].size for p in per)
            q = np.tile(tc_.time, (m, 1))
            for i, (t_i, _) in enumerate(per):
                q[:t_i.size, i] = t_i
            yv = co(q)[:, :, 1]
            ymax = float(max(np.abs(yv[:p[0].size, i]).max(initial=0.0)
                             for i, p in enumerate(per)))
            check(ymax <= HH_COUT_Y, f"HH c_output: |y| at a hit {ymax}")
            check(rc.arrays()[0].size == ts.size,
                  "HH c_output: the hits differ from propagate_until's")
            r.update(c_output_y_at_hits_max=ymax,
                     c_output_steps=int(resc[3].sum()))
        out[f"B{B}"] = r
    say(18, nvidia_smi=smi, **out)
    return out, hits


def isolation_share(make, t_end):
    """Where an event step's time goes, over a run of ``make()`` to
    ``t_end``: the jet and step size (``ev.jet_b``: the route's kernel and
    Jorba's h) timed between two device syncs, and the root finding
    (exclusion, tree, fallback, refinement) as the port's
    ``hy.events.isolate`` spans time it on the host clock, recorded with
    the logger at TRACE and its handlers held at WARNING meanwhile.  An
    isolation starts on an idle device (after the jet's sync) and holds
    the waits of its two ``nonzero`` reads; the refinement queued after
    them, with the rest of the step, is waited for by the step's exit
    test (the ``hy.sync.pu_done`` spans: ``exit_wait_s``).  Returns each
    part's share of the run's wall (with the jet's syncs), and
    ``find_roots``'s counts (rows, rows the tree took, rows it could not
    certify, Collins-Akritas iterations), its calls checked against the
    isolate spans."""
    import logging as std_logging

    ta = make()
    ev = ta._ev
    real_jet = ev.jet_b
    s0 = dict(ev.find_roots_b.stats)
    jet_s = 0.0

    def timed_jet(*a):
        nonlocal jet_s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_jet(*a)
        torch.cuda.synchronize()
        jet_s += time.perf_counter() - t0
        return out

    lg = ht.logging.logger
    levels = [(x, x.level) for x in (lg, *lg.handlers)]
    ev.jet_b = timed_jet
    ht.logging.set_logger_level_trace()
    for h in lg.handlers:
        h.setLevel(std_logging.WARNING)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        ta.propagate_until(t_end)
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    finally:
        ev.jet_b = real_jet
        for x, level in levels:
            x.setLevel(level)
    wall = (t1 - t0) / 1e9
    run = [x for x in ht.logging.spans() if x.t0_ns >= t0 and x.t1_ns <= t1]
    iso = [x for x in run if x.name == "hy.events.isolate"]
    find_roots_s = sum(x.t1_ns - x.t0_ns for x in iso) / 1e9
    exit_wait_s = sum(x.t1_ns - x.t0_ns for x in run
                      if x.name == "hy.sync.pu_done") / 1e9
    st = {k: v - s0[k] for k, v in ev.find_roots_b.stats.items()}
    check(len(iso) == st["calls"],
          f"isolation: {len(iso)} isolate spans, {st['calls']} calls")
    return dict(B=ta.batch_size, t_end=t_end, wall_s=wall,
                event_steps=st["calls"], jet_s=jet_s,
                find_roots_s=find_roots_s, exit_wait_s=exit_wait_s,
                jet_share=jet_s / wall, isolation_share=find_roots_s / wall,
                exit_wait_share=exit_wait_s / wall,
                ms_per_step=1e3 * wall / max(st["calls"], 1),
                find_roots_stats=st)


def hh_profile(ics, dev):
    """The first tenth of the HH event run, timed three times without and
    once with ``torch.profiler``: the device's busy and idle shares and
    B2's share of the busy time."""
    from torch.profiler import ProfilerActivity, profile
    t_end = HH_T / 10
    walls = [timed_call(lambda: hh_batch(ics, dev, HitArrays()),
                        lambda t: t.propagate_until(t_end))[2]
             for _ in range(3)]
    wall = sorted(walls)[1]
    tp = hh_batch(ics, dev, HitArrays())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tp.propagate_until(t_end)
        torch.cuda.synchronize()
    dev_ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e6
    b2 = sum(e.time_range.elapsed_us() for e in dev_ev
             if "jet_kernel" in e.name) / 1e6
    return dict(t_end=t_end, wall_s=walls, device_events=len(dev_ev),
                device_busy_s=busy if dev_ev else None,
                device_idle_share=1.0 - busy / wall if dev_ev else None,
                b2_share_of_busy=b2 / busy if dev_ev else None)


def event_paths(dev, smi, sys_ss, ics_ss):
    """Phase 19, terminal events and callbacks at scale: the pendulum at
    10,240 lanes (B4) with ``t_event(v, callback=continue)`` to t = 20
    (the resume loop's rounds and rate, the energy drift); mascon-512 at
    1,024 (B3) with ``nt_event(x - 1.5)`` and the impact ``t_event`` over
    two orbits (the Jacobi drift, the hits); the outer SS at 10,240 (B2)
    with a host callback that stops after 10 steps (``cb_stop`` on every
    lane); ``propagate_grid`` with the HH event to t = 20 over 201 points
    at 10,240 (B2), held to the event-free grid's rows and to
    ``propagate_until``'s hits.  Each path's counts set to 0 just before
    it and read just after."""
    from heyoka_tpu_torch.taylor import events as tev
    out = {}
    kw = dict(tol=TOL, high_accuracy=True)
    # -- the pendulum's terminal event with a callback that goes on -------
    ics_p = pendulum_lanes(PEND_B, 0)
    sys_p = ht.models.pendulum()
    xp, vp = (lhs for lhs, _ in sys_p)
    calls = [0]

    def go_on(tb, d, lane):
        calls[0] += 1
        return True

    rounds = [0]
    real = tev.propagate_until_ev

    def counted(*a, **k):
        rounds[0] += 1
        return real(*a, **k)

    def make_p():
        return ht.taylor_adaptive_batch(
            sys_p, ics_p, device=dev, t_events=[ht.t_event(
                vp, callback=go_on)], **kw)

    ht.taylor_adaptive_batch(sys_p, ics_p[:CHUNK], device=dev, t_events=[
        ht.t_event(vp, callback=go_on)], **kw).propagate_until(2.0)
    calls[0] = 0
    tev.propagate_until_ev = counted
    try:
        zero_launches()
        ta, res, wall = timed_call(make_p,
                                   lambda t: t.propagate_until(TE_PEND_T))
        launches = dict(jk.LAUNCHES)
    finally:
        tev.propagate_until_ev = real
    check(launches["phase"] > 0 and all(
        n == 0 for k, n in launches.items() if k != "phase"),
        f"pendulum te: launches {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in res[0])
          and bool((ta.time == TE_PEND_T).all()), "pendulum te: landing")
    e0 = pendulum_energy(torch.as_tensor(ics_p, device=dev))
    drift = float(((pendulum_energy(torch.as_tensor(ta.state, device=dev))
                    - e0).abs() / e0.abs()).max())
    check(drift <= DRIFT_MAX, f"pendulum te: energy drift {drift}")
    out["pendulum_te_callback"] = dict(
        B=PEND_B, t_end=TE_PEND_T, rounds=rounds[0], callbacks=calls[0],
        callbacks_per_lane=calls[0] / PEND_B, lane_steps=int(res[3].sum()),
        wall_s=wall, steps_per_s=int(res[3].sum()) / wall,
        launches=launches, energy_drift_max_rel=drift,
        isolation=isolation_share(make_p, TE_PEND_T / 4))
    # -- mascon-512 with the alias-form nt event and the impact -----------
    kw_m, rng_m = mascon_body(MASCON_N)
    orbits = mascon_lanes(rng_m, MASCON_B, kw_m["omega"])
    sys_m = ht.models.mascon(**kw_m)
    x, y, z = (lhs for lhs, _ in sys_m[:3])
    rec = HitArrays()
    zero_launches()
    tm, res, wall = timed_call(
        lambda: ht.taylor_adaptive_batch(
            sys_m, orbits, device=dev, nt_events=[ht.nt_event(x - 1.5, rec)],
            t_events=[ht.t_event(x * x + y * y + z * z - 1.0)], **kw),
        lambda t: t.propagate_until(MASCON_T))
    launches = dict(jk.LAUNCHES)
    check(launches["jet_rolled"] > 0 and all(
        n == 0 for k, n in launches.items() if k != "jet_rolled"),
        f"mascon events: launches {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in res[0]),
          "mascon events: a lane stopped (no orbit reaches the body)")
    drift = float(((jacobi(torch.as_tensor(tm.state, device=dev), kw_m)
                    - jacobi(torch.as_tensor(orbits, device=dev), kw_m)).abs()
                   / jacobi(torch.as_tensor(orbits, device=dev),
                            kw_m).abs()).max())
    check(drift <= JACOBI_MAX, f"mascon events: Jacobi drift {drift}")
    n_hits = rec.arrays()[0].size
    check(n_hits > 0, "mascon events: no lane crossed x = 1.5")
    out["mascon512_events"] = dict(
        B=MASCON_B, t_end=MASCON_T, hits=n_hits, hits_per_lane=n_hits
        / MASCON_B, lane_steps=int(res[3].sum()), wall_s=wall,
        steps_per_s=int(res[3].sum()) / wall, launches=launches,
        jacobi_drift_max_rel=drift, isolation=isolation_share(
            lambda: ht.taylor_adaptive_batch(
                sys_m, orbits, device=dev, nt_events=[ht.nt_event(
                    x - 1.5, HitArrays())], t_events=[ht.t_event(
                        x * x + y * y + z * z - 1.0)], **kw),
            MASCON_T / 4))
    # -- the outer SS with a host callback that stops after 10 steps -------
    n_cb = [0]

    def stop_at_10(tb):
        n_cb[0] += 1
        return n_cb[0] < SS_CB_STEPS

    zero_launches()
    ts_, res, wall = timed_call(
        lambda: ht.taylor_adaptive_batch(sys_ss, ics_ss, device=dev, **kw),
        lambda t: t.propagate_until(T_END, callback=stop_at_10))
    launches = dict(jk.LAUNCHES)
    check(all(o == ht.TaylorOutcome.cb_stop for o in res[0])
          and bool((res[3] == SS_CB_STEPS).all()),
          "outer SS host callback: not cb_stop after 10 steps")
    check(launches["jet"] == SS_CB_STEPS and all(
        n == 0 for k, n in launches.items() if k != "jet"),
        f"outer SS host callback: launches {launches}")
    out["outer_ss_host_callback"] = dict(
        B=B_MAIN, steps=SS_CB_STEPS, wall_s=wall, launches=launches)
    # -- the HH grid with the event against the event-free grid -----------
    grid = np.linspace(0.0, HH_GRID_T, HH_GRID_N)
    ics = hh_lanes(HH_B)
    rec_g, rec_u = HitArrays(), HitArrays()
    zero_launches()
    tg, rg, wall = timed_call(lambda: hh_batch(ics, dev, rec_g),
                              lambda t: t.propagate_grid(grid))
    launches = dict(jk.LAUNCHES)
    check(launches["jet"] > 0 and all(
        n == 0 for k, n in launches.items() if k != "jet"),
        f"HH grid: launches {launches}")
    plain = hh_batch(ics, dev).propagate_grid(grid)[4]
    hh_batch(ics, dev, rec_u).propagate_until(HH_GRID_T)
    dev_max = float(np.abs(rg[4] - plain).max())
    check(all(o == ht.TaylorOutcome.time_limit for o in rg[0])
          and dev_max <= HH_GRID_ATOL, f"HH grid vs event-free {dev_max}")
    a, b = rec_g.arrays(), rec_u.arrays()
    same = a[0].size == b[0].size and np.array_equal(a[1], b[1]) \
        and np.array_equal(a[2], b[2])
    check(same, "HH grid: hits differ from propagate_until's")
    out["hh_grid_events"] = dict(
        B=HH_B, n_grid=HH_GRID_N, t_end=HH_GRID_T, vs_event_free_max_abs=
        dev_max, hits=int(a[0].size), hit_dt_vs_until_max=float(
            np.abs(a[0] - b[0]).max(initial=0.0)), wall_s=wall,
        lane_steps=int(rg[3].sum()), launches=launches)
    say(19, nvidia_smi=smi, **out)
    return out



# -- the scalar integrator and the ensembles (phases 20-21) -------------------

FEW_LANES = (1, 3)
SCALAR_RTOL = 1e-13  # the scalar against its batch lane on the card
SCALAR_STEPS = 200  # step() latency: steps timed after SCALAR_WARM
SCALAR_WARM = 20
SCALAR_MASCON_T = MASCON_T / 10
SCALAR_EV_T = 10.0
AR_B = 1024  # the per-lane angle reducer's batch
AR_T = 10.0
ENS_GRID_T = 4.0  # the grid with events: the per-instance fallback
ENS_FALLBACK_N = 8
ENS_BATCH = 1024  # ensemble_propagate_until_batch: 10 x 1,024 lanes
ENS_FOR_HH_T = HH_T / 4
ENS_MESH = ["cuda:0"]  # a mesh of one device, named apart from "cuda"


def quartiles(xs):
    q1, med, q3 = np.percentile(np.asarray(xs, float), [25, 50, 75])
    return dict(q1=float(q1), median=float(med), q3=float(q3))


def rel_err(a, b):
    """max |a - b| over max |b| (numpy or tensors), and whether a == b."""
    a, b = (x.cpu().numpy() if isinstance(x, torch.Tensor) else
            np.asarray(x) for x in (a, b))
    return float(np.abs(a - b).max() / np.abs(b).max()), \
        bool(np.array_equal(a, b))


def guarded(t, guard=4096, fill=12345.0):
    """``t`` copied into the middle of a buffer of ``fill``: (the copy,
    the whole buffer); a kernel that writes past either end of its buffer
    changes a guard."""
    flat = torch.full((t.numel() + 2 * guard,), fill, dtype=t.dtype,
                      device=t.device)
    flat[guard:guard + t.numel()] = t.reshape(-1)
    return flat[guard:guard + t.numel()].view(t.shape), flat


def few_lane_kernels(dev, tape_ss, order):
    """B1-B4 at 1 and 3 lanes (the scalar integrator's and a small
    ensemble's widths) against their plain versions: B2 and B1 on the
    outer-SS tape, B3 on mascon-512 (its global layout's scratch sized for
    an SM's lanes), B4 on the pendulum at every block shape, with guards
    on both sides of its buffer.  Returns each kernel's largest abs error
    and the details."""
    f64 = dict(dtype=torch.float64, device=dev)
    kw_m, rng_m = mascon_body(MASCON_N)
    rtape, _ = mascon_tapes(kw_m, order, dev)
    orbits = mascon_lanes(rng_m, 8, kw_m["omega"])
    sys_p = ht.models.pendulum()
    ptape = jp.PhaseTape(ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(sys_p), order)), dev)
    errs = dict(jet=0.0, prop=0.0, jet_rolled=0.0, phase=0.0)
    out = {}
    one_ms = {}
    for B in FEW_LANES:
        st = torch.as_tensor(lanes(IC, B, 5).T.copy(), **f64)
        np0 = torch.zeros((0, B), **f64)
        tc_k, nrm_k = jk.jet(tape_ss, st, np0)
        tc_p, nrm_p = jk.jet_plain(tape_ss, st, np0)
        r2 = float(per_order_rel(tc_k, tc_p).max())
        check(r2 <= JET_RTOL and bool(torch.allclose(
            nrm_k, nrm_p, rtol=JET_RTOL, atol=0)), f"B2 at B={B}: {r2}")
        errs["jet"] = max(errs["jet"], float((tc_k - tc_p).abs().max()))
        aux = torch.stack([torch.full((B,), float("inf"), **f64),
                           torch.ones(B, **f64), torch.full((B,), FAR, **f64),
                           torch.zeros(B, **f64), torch.ones(B, **f64)])
        auxi = torch.full((1, B), 2**31 - 1, dtype=torch.int32, device=dev)
        sk, _, oik = jk.prop(tape_ss, st, np0, aux, auxi, CHUNK, True)
        sp, _, oip = jk.prop_plain(tape_ss, st, np0, aux, auxi, CHUNK, True)
        r1 = float(((sk - sp).abs().amax(1) / sp.abs().amax(1)).max())
        check(torch.equal(oik, oip) and r1 <= PROP_RTOL,
              f"B1 at B={B}: {r1}")
        errs["prop"] = max(errs["prop"], float((sk - sp).abs().max()))
        args = (torch.as_tensor(orbits[:B].T.copy(), **f64),
                torch.zeros((0, B), **f64), torch.zeros(B, **f64))
        tc_k, nrm_k = jr.jet_rolled(rtape, *args)
        tc_p, nrm_p = jr.jet_rolled_plain(rtape, *args)
        r3 = float(per_order_rel(tc_k, tc_p).max())
        check(r3 <= JET_RTOL, f"B3 at B={B}: {r3}")
        errs["jet_rolled"] = max(errs["jet_rolled"],
                                 float((tc_k - tc_p).abs().max()))
        tc0 = seeded_buffer(ptape, pendulum_lanes(B, 3), np.zeros((B, 0)),
                            np.zeros(B), dev)
        tc_p = jp.phase_plain(ptape, tc0.clone(), 1)
        r4 = 0.0
        for lay, L, nt in [(None, None, None)] + jp.sweep_shapes(ptape, 8):
            buf, flat = guarded(tc0)
            jp._phase_cuda(ptape, buf, 1, L, nt, lay)
            torch.cuda.synchronize()
            check(bool((flat[:4096] == 12345.0).all()
                       and (flat[-4096:] == 12345.0).all()),
                  f"B4 at B={B} ({lay}, {L} x {nt}) wrote past its buffer")
            r = float(per_order_rel(buf.permute(1, 0, 2),
                                    tc_p.permute(1, 0, 2)).max())
            check(r <= JET_RTOL, f"B4 at B={B} ({lay}, {L} x {nt}): {r}")
            r4 = max(r4, r)
            errs["phase"] = max(errs["phase"], float((buf - tc_p).abs().max()))
        if B == 1:
            # each kernel's time at one lane (B1: one 64-step chunk; B4
            # replayed from a CUDA graph, the others back to back)
            buf = tc0.clone()
            one_ms = dict(
                b2_jet=cuda_ms(lambda: jk.jet(tape_ss, st, np0), 20),
                b1_chunk=cuda_ms(lambda: jk.prop(tape_ss, st, np0, aux, auxi,
                                                 CHUNK, True), 5),
                b3_jet=cuda_ms(lambda: jr.jet_rolled(rtape, *args), 20),
                b4_phase_graph=graph_ms(lambda: jp.phase(ptape, buf, 1), 20))
        out[f"B{B}"] = dict(b2_max_rel_per_order=r2, b1_state_max_rel=r1,
                            b3_max_rel_per_order=r3,
                            b4_max_rel_per_order_every_shape=r4,
                            b4_layout=jp.layout_report(ptape, B),
                            b3_layout=jr.layout_report(rtape))
    out["one_lane_kernel_ms"] = one_ms
    return errs, out


def step_busy(ta, median_ms, n=50):
    """``n`` more ``step()`` calls under ``torch.profiler``: the device's
    busy time, its kernels a step, and its idle share against ``n`` steps
    at the unprofiled median ``median_ms``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            ta.step()
        torch.cuda.synchronize()
    dev_ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
    return dict(steps=n, device_kernels_per_step=len(dev_ev) / n,
                device_busy_ms_per_step=busy / n if dev_ev else None,
                device_idle_share=1.0 - busy / (n * median_ms)
                if dev_ev else None)


def step_latency(ta):
    """Wall ms of each of ``SCALAR_STEPS`` ``step()`` calls after
    ``SCALAR_WARM`` (each call ends in its outcome's host copy)."""
    for _ in range(SCALAR_WARM):
        ta.step()
    ms = []
    for _ in range(SCALAR_STEPS):
        t0 = time.perf_counter()
        ta.step()
        ms.append(1e3 * (time.perf_counter() - t0))
    return dict(quartiles(ms), steps=SCALAR_STEPS)


def scalar_run(name, make, t_end, kernels, inv=None):
    """``make(dev)``'s ``propagate_until(t_end)`` on the card, the counts
    set to 0 just before it and read just after: only ``kernels``
    launched (each at least once), ``time_limit``, the landing exact, the
    invariant ``inv`` (of (1, n) states) kept to ``DRIFT_MAX``.  Returns
    the integrator and the summary."""
    ta = make()
    st0 = torch.as_tensor(ta.state[None], device=ta.device)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    oc, min_h, max_h, ns = ta.propagate_until(t_end)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(jk.LAUNCHES)
    check(all(launches[k] > 0 for k in kernels) and all(
        n == 0 for k, n in launches.items() if k not in kernels),
        f"scalar {name}: launches {launches}")
    check(oc == ht.TaylorOutcome.time_limit and ta.time == t_end,
          f"scalar {name}: {oc} at {ta.time}")
    r = dict(t_end=t_end, nsteps=ns, wall_s=wall, steps_per_s=ns / wall,
             launches=launches, engine=ta.engine_report()["propagate_engine"])
    if inv is not None:
        st = torch.as_tensor(ta.state[None], device=ta.device)
        r["drift_max_rel"] = float(((inv(st) - inv(st0)).abs()
                                    / inv(st0).abs()).max())
        check(r["drift_max_rel"] <= DRIFT_MAX,
              f"scalar {name}: drift {r['drift_max_rel']}")
    return ta, r


def scalar_paths(dev, smi, sys_ss, ics_ss, st_fused, tape_ss, order):
    """Phase 20, the scalar integrator on the card: B1-B4 at 1 and 3 lanes
    against their plain versions; ``taylor_adaptive`` on the outer SS
    (lane 0 of phase 5: B1 and B2, held to phase 5's lane), the pendulum
    (B4) and mascon-512 (B3; one ``step()`` and a short propagation), each
    against a 3-lane batch's lane 0 on the card and the CPU run; the
    ``step()`` latency on each route; the pendulum with a terminal event
    whose callback goes on twice and a non-terminal one, held to the CPU;
    the per-lane ``AngleReducer`` on a circulating pendulum, scalar and at
    1,024 lanes, and its vmap's cost (:func:`vmap_cost`).  Returns the launches of each path and the kernels'
    errors at few lanes."""
    kw = dict(tol=TOL, high_accuracy=True)
    errs, few = few_lane_kernels(dev, tape_ss, order)
    res = {"few_lanes": few}
    paths = {}
    # -- the outer SS: kernels B1 and B2 ---------------------------------
    ht.taylor_adaptive(sys_ss, ics_ss[1], device=dev, **kw).propagate_until(
        1.0)
    ta, r = scalar_run("outer SS", lambda: ht.taylor_adaptive(
        sys_ss, ics_ss[0], device=dev, **kw), T_END, ("jet", "prop"))
    e = energy(torch.as_tensor(np.stack([ics_ss[0], ta.state]), device=dev),
               MASSES, GCONST)
    r["drift_max_rel"] = float(((e[1] - e[0]) / e[0]).abs())
    check(r["drift_max_rel"] <= DRIFT_MAX, f"scalar outer SS: drift {r}")
    r["vs_phase5_lane0_max_rel"], r["vs_phase5_lane0_same_bits"] = rel_err(
        ta.state, st_fused[0])
    check(r["vs_phase5_lane0_max_rel"] <= SCALAR_RTOL,
          f"scalar outer SS vs phase 5's lane 0: {r}")
    paths["outer_ss"] = r["launches"]
    res["outer_ss"] = r
    # -- the pendulum: kernel B4 ------------------------------------------
    sys_p = ht.models.pendulum()
    ics_p = pendulum_lanes(PEND_B, 0)[:3]
    ta, r = scalar_run("pendulum", lambda: ht.taylor_adaptive(
        sys_p, ics_p[0], device=dev, **kw), PEND_T, ("phase",),
        pendulum_energy)
    paths["pendulum"] = r["launches"]
    three = ht.taylor_adaptive_batch(sys_p, ics_p, device=dev, **kw)
    three.propagate_until(PEND_T)
    cpu = ht.taylor_adaptive(sys_p, ics_p[0], device="cpu", **kw)
    cpu.propagate_until(PEND_T)
    r["vs_batch3_lane0_max_rel"], r["vs_batch3_lane0_same_bits"] = rel_err(
        ta.state, three.state[0])
    r["cpu_ref_max_rel"] = rel_err(ta.state, cpu.state)[0]
    check(r["vs_batch3_lane0_max_rel"] <= SCALAR_RTOL
          and r["cpu_ref_max_rel"] <= REF_RTOL, f"scalar pendulum: {r}")
    res["pendulum"] = r
    # -- mascon-512: kernel B3 --------------------------------------------
    kw_m, rng_m = mascon_body(MASCON_N)
    sys_m = ht.models.mascon(**kw_m)
    orbits = mascon_lanes(rng_m, 3, kw_m["omega"])
    tm = ht.taylor_adaptive(sys_m, orbits[0], device=dev, **kw)
    zero_launches()
    oc, h = tm.step()
    torch.cuda.synchronize()
    step_launches = dict(jk.LAUNCHES)
    check(oc == ht.TaylorOutcome.success and step_launches["jet_rolled"] == 1
          and sum(step_launches.values()) == 1,
          f"scalar mascon-512 step: {oc}, {step_launches}")

    def jac(st):
        return jacobi(st, kw_m)

    tm, r = scalar_run("mascon-512", lambda: ht.taylor_adaptive(
        sys_m, orbits[0], device=dev, **kw), SCALAR_MASCON_T,
        ("jet_rolled",), jac)
    three = ht.taylor_adaptive_batch(sys_m, orbits, device=dev, **kw)
    three.propagate_until(SCALAR_MASCON_T)
    cpu = ht.taylor_adaptive(sys_m, orbits[0], device="cpu", **kw)
    cpu.propagate_until(SCALAR_MASCON_T)
    r["vs_batch3_lane0_max_rel"], r["vs_batch3_lane0_same_bits"] = rel_err(
        tm.state, three.state[0])
    r["cpu_ref_max_rel"] = rel_err(tm.state, cpu.state)[0]
    check(r["vs_batch3_lane0_max_rel"] <= SCALAR_RTOL
          and r["cpu_ref_max_rel"] <= REF_RTOL, f"scalar mascon-512: {r}")
    r["step"] = dict(outcome=str(oc), h=h, launches=step_launches)
    paths["mascon512"] = dict(step_launches, **{
        k: v + step_launches[k] for k, v in r["launches"].items()})
    res["mascon512"] = r
    # -- step() latency at one lane ----------------------------------------
    lat = {}
    for name, make, kern in (
            ("outer_ss_b2", lambda: ht.taylor_adaptive(
                sys_ss, ics_ss[0], device=dev, **kw), "jet"),
            ("pendulum_b4", lambda: ht.taylor_adaptive(
                sys_p, ics_p[0], device=dev, **kw), "phase"),
            ("mascon512_b3", lambda: ht.taylor_adaptive(
                sys_m, orbits[0], device=dev, **kw), "jet_rolled")):
        zero_launches()
        ta = make()
        lat[name] = step_latency(ta)
        check(jk.LAUNCHES[kern] == SCALAR_STEPS + SCALAR_WARM,
              f"step latency {name}: launches {dict(jk.LAUNCHES)}")
        lat[name]["launches"] = dict(jk.LAUNCHES)
        paths[f"step_{name}"] = lat[name]["launches"]
        lat[name]["profile"] = step_busy(ta, lat[name]["median"])
    res["step_latency_ms"] = lat
    # -- the pendulum with events ------------------------------------------
    xp, vp = (lhs for lhs, _ in sys_p)

    def with_events(device):
        hits, stops = [], []

        def on_te(ta_, d_sgn):
            stops.append((ta_.time, d_sgn))
            return len(stops) < 3

        ta_ = ht.taylor_adaptive(
            sys_p, ics_p[1], device=device, **kw,
            t_events=[ht.t_event(vp, callback=on_te)],
            nt_events=[ht.nt_event(xp, lambda ta_, t, d: hits.append(
                (t, d)))])
        return ta_, hits, stops

    tg, hg, sg = with_events(dev)
    zero_launches()
    rg = tg.propagate_until(SCALAR_EV_T)
    torch.cuda.synchronize()
    ev_launches = dict(jk.LAUNCHES)
    tc_, hc, sc = with_events("cpu")
    rc = tc_.propagate_until(SCALAR_EV_T)
    check(ev_launches["phase"] > 0 and sum(ev_launches.values())
          == ev_launches["phase"], f"scalar events: launches {ev_launches}")
    same = (len(hg) == len(hc) and [d for _, d in hg] == [d for _, d in hc]
            and [d for _, d in sg] == [d for _, d in sc] and rg[0] == rc[0])
    dt = max([abs(a[0] - b[0]) for a, b in zip(hg + sg, hc + sc)],
             default=0.0)
    check(same and len(sg) == 3 and dt <= HH_HIT_ATOL,
          f"scalar events vs the CPU run: {len(hg)}/{len(hc)} hits, "
          f"{len(sg)} stops, dt {dt}")
    res["pendulum_events"] = dict(outcome=int(rg[0]), nsteps=rg[3],
                                  hits=len(hg), stops=len(sg),
                                  hit_dt_vs_cpu_max=dt,
                                  launches=ev_launches)
    paths["pendulum_events"] = ev_launches
    # -- the per-lane angle reducer on circulating pendulums -----------------
    rng = np.random.default_rng(4)
    circ = np.stack([np.zeros(AR_B), rng.uniform(6.5, 8.0, AR_B)], 1)
    zero_launches()
    tb = ht.taylor_adaptive_batch(sys_p, circ, device=dev, **kw)
    rb = tb.propagate_until(AR_T, callback=ht.AngleReducer(["x"]))
    ts_ = ht.taylor_adaptive(sys_p, circ[0], device=dev, **kw)
    rs = ts_.propagate_until(AR_T, callback=ht.AngleReducer(["x"]))
    torch.cuda.synchronize()
    ar_launches = dict(jk.LAUNCHES)
    xs = tb.state[:, 0]
    e = pendulum_energy(torch.as_tensor(np.concatenate([circ, tb.state]),
                                        device=dev))
    drift = float(((e[AR_B:] - e[:AR_B]).abs() / e[:AR_B].abs()).max())
    ar_rel = rel_err(ts_.state, tb.state[0])
    check(all(o == ht.TaylorOutcome.time_limit for o in rb[0])
          and rs[0] == ht.TaylorOutcome.time_limit
          and bool(((xs >= 0) & (xs < 2 * np.pi)).all())
          and 0.0 <= ts_.state[0] < 2 * np.pi and drift <= DRIFT_MAX
          and ar_rel[0] <= SCALAR_RTOL and ar_launches["phase"] > 0,
          f"angle reducer: drift {drift}, scalar vs lane 0 {ar_rel}, "
          f"{ar_launches}")
    res["angle_reducer"] = dict(B=AR_B, t_end=AR_T, energy_drift_max_rel=
                                drift, scalar_vs_lane0=ar_rel,
                                launches=ar_launches,
                                vmap_cost=vmap_cost(sys_p, circ, dev, kw))
    paths["angle_reducer"] = ar_launches
    say(20, nvidia_smi=smi, **res)
    return paths, errs


def vmap_cost(sys_p, circ, dev, kw):
    """What running the reducer per lane under ``torch.func.vmap`` costs
    the per-step driver at ``AR_B`` lanes: ``propagate_until(AR_T)`` with
    the ``AngleReducer`` and with no callback, in turns (reducer, none,
    none, reducer; each batch built before its timer starts), as wall ms
    a loop iteration (the lockstep driver's iterations are the lanes'
    most steps); and the host ms of one ``callback.apply`` call beside one
    call of the same reduction written for the whole batch, on the
    driver's tensors (medians of ``SCALAR_STEPS`` calls, each ended by a
    device sync)."""
    walls = {"reducer": [], "none": []}
    for key in ("reducer", "none", "none", "reducer"):
        tb = ht.taylor_adaptive_batch(sys_p, circ, device=dev, **kw)
        cb = ht.AngleReducer(["x"]) if key == "reducer" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = tb.propagate_until(AR_T, callback=cb)
        torch.cuda.synchronize()
        walls[key].append(1e3 * (time.perf_counter() - t0)
                          / int(np.max(r[3])))
    red = ht.AngleReducer(["x"])
    red.pre_hook(tb)
    args = (tb._state, tb._pars, tb._t_hi, tb._t_lo, tb._last_h, tb._tc)
    twopi = 2.0 * np.pi

    def whole(state, *_):
        x = state[:, :1]
        return torch.cat([x - twopi * torch.floor(x / twopi), state[:, 1:]],
                         1), True

    host = {}
    for name, fn in (("vmap_apply", lambda: ht.callback.apply(red, *args)),
                     ("whole_batch", lambda: whole(*args))):
        ms = []
        for _ in range(SCALAR_WARM + SCALAR_STEPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        host[name] = float(np.median(ms[SCALAR_WARM:]))
    per = {k: float(np.median(v)) for k, v in walls.items()}
    return dict(ms_per_iteration=walls, median_ms_per_iteration=per,
                reducer_minus_none_ms=per["reducer"] - per["none"],
                call_ms=host,
                vmap_minus_whole_ms=host["vmap_apply"] - host["whole_batch"])


def turns(make_ens, build_raw, run_raw):
    """The ensemble and the raw batch on the same lanes, in turns
    (ensemble, raw, raw, ensemble; each call between two device syncs):
    the first ensemble call's wall, the later one's, the raw walls, the
    lane-steps/s of each and the ratio of the medians (raw over
    ensemble).  The raw batch is built (``build_raw()``) before its timer
    starts and only ``run_raw(tb)`` is timed, as the ensemble reuses its
    template's tape; the constructor's walls stand apart.  Returns the
    summary and the first ensemble call's result."""
    walls, rates, first = {"ens": [], "raw": []}, {"ens": [], "raw": []}, \
        None
    build = []
    for key in ("ens", "raw", "raw", "ens"):
        if key == "raw":
            t0 = time.perf_counter()
            tb = build_raw()
            torch.cuda.synchronize()
            build.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = make_ens() if key == "ens" else run_raw(tb)
        torch.cuda.synchronize()
        w = time.perf_counter() - t0
        if first is None:
            first = r
        walls[key].append(w)
        rates[key].append((ens_steps if key == "ens" else batch_steps)(r)
                          / w)
    return dict(first_call_s=walls["ens"][0], later_call_s=walls["ens"][1],
                ensemble_wall_s=walls["ens"], raw_wall_s=walls["raw"],
                raw_build_s=build, ensemble_steps_per_s=rates["ens"],
                raw_steps_per_s=rates["raw"],
                raw_over_ensemble=float(np.median(rates["raw"])
                                        / np.median(rates["ens"]))), first


def ens_steps(r):
    return int(r["nsteps"].sum())


def batch_steps(r):
    return int(np.asarray(r[3]).sum())


def ensemble_paths(dev, smi, sys_ss, ics_ss, st_fused, pend_rows, hh_hits):
    """Phase 21, ensembles at full width: the outer-SS template's
    ``ensemble_propagate_until`` over phase 5's 10,240 lanes (B1 and B2,
    held to phase 5's states) and ``ensemble_propagate_for``; the
    pendulum's ``ensemble_propagate_grid`` over phase 15's grid (B4, held
    to phase 15's rows); the Henon-Heiles ``nt_event`` ensemble to t = 200
    (B2, its hits held to phase 18's) and its ``_for`` to t = 50; the grid
    with events and the terminal-event callbacks on 8 pendulum instances
    (the per-instance fallback, B4, each equal to its own scalar run);
    ``ensemble_propagate_until_batch`` with a 1,024-lane template and
    n_iter = 10 (held to phase 5's lanes); a ``mesh=["cuda:0"]`` run equal
    to the plain one.  Each row of the ensemble table (until/for/grid x
    plain/events) times the ensemble beside the raw batch on the same
    lanes in turns.  Returns the launches of each path."""
    kw = dict(tol=TOL, high_accuracy=True)
    B = len(ics_ss)
    gen = {"state": ics_ss}
    res, paths, table = {}, {}, {}

    def counted(name, fn, kernels):
        zero_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = dict(jk.LAUNCHES)
        check(all(launches[k] > 0 for k in kernels) and all(
            n == 0 for k, n in launches.items() if k not in kernels),
            f"ensemble {name}: launches {launches}")
        paths[name] = launches
        return out

    # -- until / for on the outer SS: B1 and B2 -------------------------------
    tmpl = ht.taylor_adaptive(sys_ss, ics_ss[0], device=dev, **kw)
    st0 = tmpl.state.copy()

    def raw_ss():
        return ht.taylor_adaptive_batch(sys_ss, ics_ss, device=dev, **kw)

    table["until_plain"], first = turns(
        lambda: counted("until_outer_ss", lambda: ht.ensemble_propagate_until(
            tmpl, T_END, B, gen), ("jet", "prop")), raw_ss,
        lambda tb: tb.propagate_until(T_END))
    check(bool((first["outcome"] == int(ht.TaylorOutcome.time_limit)).all()
               and (first["time"] == T_END).all()), "ensemble until: landing")
    res["until_vs_phase5"] = rel_err(first["state"], st_fused)
    check(res["until_vs_phase5"][0] <= SCALAR_RTOL,
          f"ensemble until vs phase 5: {res['until_vs_phase5']}")
    check(np.array_equal(tmpl.state, st0) and tmpl.time == 0.0,
          "ensemble until: the template moved")

    table["for_plain"], rf = turns(
        lambda: counted("for_outer_ss", lambda: ht.ensemble_propagate_for(
            tmpl, T_END, B, gen), ("jet", "prop")), raw_ss,
        lambda tb: tb.propagate_for(T_END))
    res["for_vs_until"] = rel_err(rf["state"], first["state"])
    check(res["for_vs_until"][1], "ensemble for: not until's states")
    # -- the pendulum's grid: B4 ----------------------------------------------
    sys_p = ht.models.pendulum()
    ics_p = pendulum_lanes(PEND_B, 0)
    grid = np.linspace(0.0, PEND_T, PEND_GRID_N)
    tp = ht.taylor_adaptive(sys_p, ics_p[0], device=dev, **kw)
    table["grid_plain"], rg = turns(
        lambda: counted("grid_pendulum", lambda: ht.ensemble_propagate_grid(
            tp, grid, PEND_B, {"state": ics_p}), ("phase",)),
        lambda: ht.taylor_adaptive_batch(sys_p, ics_p, device=dev, **kw),
        lambda tb: tb.propagate_grid(grid))
    res["grid_vs_phase15"] = rel_err(rg["out"], pend_rows)
    check(res["grid_vs_phase15"][0] <= SCALAR_RTOL
          and bool((rg["outcome"] == int(ht.TaylorOutcome.time_limit)).all()),
          f"ensemble grid vs phase 15: {res['grid_vs_phase15']}")
    del rg
    # -- the HH Poincare section: B2 on the event path ------------------------
    sys_h, y = hh_sys()
    ics_h = hh_lanes(HH_B)
    seen = [0]

    def on_hit(results, t, d_sgn, instance):
        seen[0] += 1

    th = ht.taylor_adaptive(sys_h, ics_h[0], device=dev, **kw, nt_events=[
        ht.nt_event(y, on_hit, direction=ht.EventDirection.positive)])
    table["until_events"], rh = turns(
        lambda: counted("until_hh_events", lambda: ht.ensemble_propagate_until(
            th, HH_T, HH_B, {"state": ics_h}), ("jet",)),
        lambda: hh_batch(ics_h, dev, HitArrays()),
        lambda tb: tb.propagate_until(HH_T))
    ts, sg, ln = hh_hits
    count = rh["nt_count"].cpu().numpy()
    ref_count = np.bincount(ln, minlength=HH_B)
    check(np.array_equal(count, ref_count), "ensemble HH: hit counts")
    slot = np.arange(ln.size) - np.repeat(np.cumsum(ref_count) - ref_count,
                                          ref_count)
    mine_t = rh["nt_times"].cpu().numpy()[ln, slot]
    mine_s = rh["nt_sgn"].cpu().numpy()[ln, slot]
    dt = float(np.abs(mine_t - ts).max(initial=0.0))
    check(np.array_equal(mine_s, sg) and dt <= HH_HIT_ATOL,
          f"ensemble HH: hits vs phase 18 {dt}")
    check(seen[0] == 2 * ts.size, "ensemble HH: callbacks")
    res["hh_events"] = dict(hits=int(ts.size), hit_dt_vs_phase18_max=dt,
                            callbacks=seen[0] // 2)
    del rh
    table["for_events"], _ = turns(
        lambda: counted("for_hh_events", lambda: ht.ensemble_propagate_for(
            th, ENS_FOR_HH_T, HH_B, {"state": ics_h}), ("jet",)),
        lambda: hh_batch(ics_h, dev, HitArrays()),
        lambda tb: tb.propagate_for(ENS_FOR_HH_T))
    # -- the per-instance fallbacks on 8 pendulum instances: B4 ---------------
    xp, vp = (lhs for lhs, _ in sys_p)
    ics8 = ics_p[:ENS_FALLBACK_N]
    grid_e = np.linspace(0.0, ENS_GRID_T, 41)

    def nt_ev():
        return [ht.nt_event(xp, lambda *a: None)]

    tg = ht.taylor_adaptive(sys_p, ics8[0], device=dev, **kw,
                            nt_events=nt_ev())
    table["grid_events"], rge = turns(
        lambda: counted("grid_events_fallback", lambda:
                        ht.ensemble_propagate_grid(tg, grid_e, ENS_FALLBACK_N,
                                                   {"state": ics8}),
                        ("phase",)),
        lambda: ht.taylor_adaptive_batch(sys_p, ics8, device=dev, **kw,
                                         nt_events=nt_ev()),
        lambda tb: tb.propagate_grid(grid_e))

    def go_on(ta_, d_sgn):
        return True

    te = [ht.t_event(vp, callback=go_on)]
    tt = ht.taylor_adaptive(sys_p, ics8[0], device=dev, **kw, t_events=te)
    table["until_te_callback"], rte = turns(
        lambda: counted("until_te_fallback", lambda:
                        ht.ensemble_propagate_until(tt, ENS_GRID_T,
                                                    ENS_FALLBACK_N,
                                                    {"state": ics8}),
                        ("phase",)),
        lambda: ht.taylor_adaptive_batch(
            sys_p, ics8, device=dev, **kw, t_events=[ht.t_event(
                vp, callback=lambda tb, d, lane: True)]),
        lambda tb: tb.propagate_until(ENS_GRID_T))
    worst = 0.0
    for i in range(ENS_FALLBACK_N):
        one = ht.taylor_adaptive(sys_p, ics8[i], device=dev, **kw,
                                 t_events=te)
        one.propagate_until(ENS_GRID_T)
        rel, _ = rel_err(rte["state"][i], one.state)
        og = ht.taylor_adaptive(sys_p, ics8[i], device=dev, **kw,
                                nt_events=nt_ev())
        rel_g, _ = rel_err(rge["out"][i], og.propagate_grid(grid_e)[4])
        worst = max(worst, rel, rel_g)
    check(worst <= SCALAR_RTOL, f"ensemble fallbacks vs own runs: {worst}")
    res["fallbacks_vs_own_scalar_runs_max_rel"] = worst
    # -- ensemble_propagate_until_batch: 10 x 1,024 lanes ---------------------
    n_it = B // ENS_BATCH
    tab = ht.taylor_adaptive_batch(sys_ss, ics_ss[:ENS_BATCH], device=dev,
                                   **kw)
    rb = counted("until_batch", lambda: ht.ensemble_propagate_until_batch(
        tab, T_END, n_it, {"state": ics_ss.reshape(n_it, ENS_BATCH, -1)}),
        ("jet", "prop"))
    res["until_batch_vs_phase5"] = rel_err(rb["state"].reshape(B, -1),
                                           st_fused)
    check(res["until_batch_vs_phase5"][0] <= SCALAR_RTOL,
          f"ensemble until_batch: {res['until_batch_vs_phase5']}")
    # -- one mesh of one device -----------------------------------------------
    rm = counted("mesh_cuda0", lambda: ht.ensemble_propagate_until(
        tmpl, T_END, B, gen, mesh=ENS_MESH), ("jet", "prop"))
    res["mesh_vs_plain"] = rel_err(rm["state"], first["state"])
    check(res["mesh_vs_plain"][1], f"mesh: {res['mesh_vs_plain']}")
    for name, row in table.items():
        print(f"ensemble table {name}: ensemble first "
              f"{row['first_call_s']:.4f} s, later {row['later_call_s']:.4f} s, ensemble "
              f"{np.median(row['ensemble_steps_per_s']):.0f} lane-steps/s, "
              f"raw {np.median(row['raw_steps_per_s']):.0f} (built "
              f"{np.median(row['raw_build_s']):.4f} s apart), raw/ensemble "
              f"{row['raw_over_ensemble']:.4f}", flush=True)
    say(21, nvidia_smi=smi, B=B, tol=SCALAR_RTOL, table=table, **res)
    return paths


VAR_MU = 0.01
VAR_IC = np.array([-0.45, 0.80, -0.80, -0.45])  # benchmarks/var_bench.py
VAR_B = (2048, 10_240)
VAR_T = 10.0
VAR_DET = 1e-10  # |det STM - 1|: the PCR3BP is Hamiltonian
VAR_SCALAR_RTOL = 1e-13
VAR_REF_RTOL = 1e-11
CR3BP_IC = np.array([-0.45, 0.80, 0.0, -0.80, -0.45, 0.0])
CR3BP_B = 1024
CR3BP_T = 12.0  # about 100 steps of the order-2 system
CR3BP_REF_LANES = 2
TM_D = 1e-4  # the Taylor map's deviation, then half of it
TM_RATIO = (6.0, 10.0)  # an order-2 map's error: d^3, 8x when d halves
NN_HIDDEN = 16
NN_B = 1024
NN_T = 1.0
NN_FD_H = 1e-6
NN_FD_PARS = 8
NN_FD_LANES = 4
NN_FD_RTOL = 1e-6
NN_REF_RTOL = 1e-12
CF_N = 2 ** 20
CF_RTOL = 1e-14
CF_PROFILE_CALLS = 10


def var_lanes(B):
    """``var_bench.py``'s lanes: the initial conditions perturbed by 1e-6
    N(0, 1) (rng 0), lane 0 unperturbed."""
    rng = np.random.default_rng(0)
    st = VAR_IC[None] + 1e-6 * rng.standard_normal((B, 4))
    st[0] = VAR_IC
    return st


def rel_max(a, b):
    """max |a - b| over max |b| (arrays or tensors)."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def jacobi_cf(dev, mu=VAR_MU):
    """The CR3BP's Jacobi constant as the port's cfunc on ``dev``, inputs
    (x, y, z, px, py, pz)."""
    return ht.make_cfunc([ht.models.cr3bp_jacobi(mu=mu)],
                         vars=["x", "y", "z", "px", "py", "pz"], device=dev)


def planar_jacobi(cf, st):
    """The Jacobi constant of PCR3BP states (B, >= 4: x, y, px, py first)
    with z = pz = 0, per lane."""
    st = torch.as_tensor(np.ascontiguousarray(st[:, :4]), device=cf.device)
    z = torch.zeros_like(st[:, 0])
    return cf(torch.stack([st[:, 0], st[:, 1], z, st[:, 2], st[:, 3], z],
                          1))[:, 0]


def jet_parity(tape, full, dev, n_steps=CHUNK, what="the variational tape",
               jet_rtol=JET_RTOL, far=FAR):
    """Kernels B2 and B1 against their twins on ``what``'s lanes ``full
    (B, n)``: B2 per order and its norms (``jet_rtol``), B1's one chunk
    with ``far`` time units left to go (flags equal, state 1e-11); their
    times (``cuda_ms``, two windows in turns with the twins) and
    bounds."""
    f64 = dict(dtype=torch.float64, device=dev)
    B = full.shape[0]
    st = torch.as_tensor(full.T.copy(), **f64)
    npar = torch.zeros((0, B), **f64)
    aux = torch.stack([torch.full((B,), float("inf"), **f64),
                       torch.ones(B, **f64), torch.full((B,), far, **f64),
                       torch.zeros(B, **f64), torch.ones(B, **f64)])
    auxi = torch.full((1, B), 2**31 - 1, dtype=torch.int32, device=dev)
    runs = {"jet": (lambda: jk.jet(tape, st, npar),
                    lambda: jk.jet_plain(tape, st, npar)),
            "prop": (lambda: jk.prop(tape, st, npar, aux, auxi, n_steps),
                     lambda: jk.prop_plain(tape, st, npar, aux, auxi,
                                           n_steps))}
    (tc_k, nrm_k), (tc_p, nrm_p) = runs["jet"][0](), runs["jet"][1]()
    rel_j = float(per_order_rel(tc_k, tc_p).max())
    nrel = float(((nrm_k - nrm_p).abs() / nrm_p.abs()).max())
    check(rel_j <= jet_rtol and nrel <= jet_rtol,
          f"B2 vs jet_plain on {what}: {rel_j}, norms {nrel}")
    (sk, ofk, oik), (sp, ofp, oip) = runs["prop"][0](), runs["prop"][1]()
    check(torch.equal(oik, oip), f"B1 vs prop_plain on {what}: "
          "n_taken/near/err differ")
    rel_p = float(((sk - sp).abs().amax(1) / sp.abs().amax(1)).max())
    check(rel_p <= PROP_RTOL, f"B1 vs prop_plain on {what}: "
          f"state {rel_p}")
    t = {}
    for name, (kern, plain) in runs.items():
        p1 = cuda_ms(plain, 1)
        k1, k2 = cuda_ms(kern, 3), cuda_ms(kern, 3)
        t[name] = ([k1, k2], [p1, cuda_ms(plain, 1)])
    jet_fl = rl.jet_flops(tape.arrays)
    tables = (tape.itab, tape.dtab)
    n_jets = int(oik[0].sum() + (oik[1] | oik[2]).sum())
    bnd = {"jet": rl.bound(jet_fl * B, rl.nbytes(st, *tables, tc_k, nrm_k),
                           torch.float64),
           "prop": rl.bound(n_jets * jet_fl + int(oik[0].sum())
                            * rl.step_flops(tape.n_eq, tape.order),
                            rl.nbytes(st, aux, auxi, *tables, sk, ofk, oik),
                            torch.float64)}
    return dict(
        jet=dict(timed(*t["jet"], bnd["jet"]), max_rel_per_order=rel_j,
                 norms_max_rel=nrel, ms_runs=t["jet"][0],
                 max_abs_err=float((tc_k - tc_p).abs().max())),
        prop=dict(timed(*t["prop"], bnd["prop"]), state_max_rel=rel_p,
                  ms_runs=t["prop"][0], steps=n_steps,
                  mean_steps_taken=float(oik[0].double().mean()),
                  max_abs_err=float((sk - sp).abs().max())))


def var_config4(dev, smi, order):
    """Phase 22 (a): BASELINE config 4 at ``var_bench.py``'s shape on
    kernels B1/B2.  Returns the kernels' rows (times, errors), the
    launches on each path and the phase line's fields."""
    t0 = time.perf_counter()
    vsys = ht.var_ode_sys(ht.models.pcr3bp(mu=VAR_MU), ht.VarArgs.vars,
                          order=1)
    build_s = time.perf_counter() - t0
    plan = build_plan(ht.taylor_decompose_sys(vsys.sys), order)
    tape = jk.JetTape(ht.plan_to_arrays(plan), dev)
    par = jet_parity(tape, vsys.initial_state(var_lanes(VAR_B[0])), dev)
    kw = dict(tol=TOL, high_accuracy=True)
    cf = jacobi_cf(dev)
    warm = ht.taylor_adaptive_batch(vsys, var_lanes(CHUNK), device=dev, **kw)
    warm.propagate_until(1.0)
    runs, paths, lane0 = {}, {}, None
    for B in VAR_B:
        ics = var_lanes(B)
        ta = ht.taylor_adaptive_batch(vsys, ics, device=dev, **kw)
        ta.assert_engine(jet="hy_jet_f64", propagate_engine="fused",
                         prop="hy_prop_f64")
        check(ta.is_variational and ta.get_n_orig_sv() == 4
              and ta.dim == 20, "config 4: not the variational batch")
        j0 = planar_jacobi(cf, ics)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        oc, _, _, nsteps = ta.propagate_until(VAR_T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = paths[f"var_pcr3bp_B{B}"] = dict(jk.LAUNCHES)
        check(launches["jet"] > 0 and launches["prop"] > 0
              and launches["jet_rolled"] == launches["phase"] == 0,
              f"config 4 at B={B}: kernels launched {launches}")
        check(all(o == ht.TaylorOutcome.time_limit for o in oc),
              f"config 4 at B={B}: an outcome is not time_limit")
        check(bool((ta.time == VAR_T).all()),
              f"config 4 at B={B}: a lane did not land on the target")
        st = ta.state
        check(bool(np.isfinite(st).all()), f"config 4 at B={B}: non-finite")
        stm = torch.as_tensor(st[:, ta.get_vslice(1)], device=dev).reshape(
            B, 4, 4)
        det_err = float((torch.linalg.det(stm) - 1.0).abs().max())
        check(det_err <= VAR_DET, f"config 4 at B={B}: |det STM - 1| = "
              f"{det_err}")
        j1 = planar_jacobi(cf, st)
        drift = float(((j1 - j0).abs() / j0.abs()).max())
        check(drift <= JACOBI_MAX, f"config 4 at B={B}: Jacobi drift {drift}")
        steps = int(nsteps.sum())
        runs[f"B{B}"] = dict(wall_s=wall, lane_steps=steps,
                             steps_per_s=steps / wall,
                             mean_steps_per_lane=steps / B,
                             launches=launches, det_max_err=det_err,
                             jacobi_drift_max_rel=drift)
        if B == VAR_B[0]:
            lane0, ref_ics, first = st[0], ics[:REF_LANES], ta
    # lane 0 against the scalar integrator on the card
    ts = ht.taylor_adaptive(vsys, VAR_IC, device=dev, **kw)
    torch.cuda.synchronize()
    zero_launches()
    ts.propagate_until(VAR_T)
    torch.cuda.synchronize()
    paths["var_scalar_pcr3bp"] = dict(jk.LAUNCHES)
    sc_rel = rel_max(ts.state, lane0)
    check(sc_rel <= VAR_SCALAR_RTOL, f"config 4: the scalar against lane 0: "
          f"{sc_rel}")
    # the lanes against the port's CPU run
    ref = ht.taylor_adaptive_batch(vsys, ref_ics, device="cpu", **kw)
    ref.propagate_until(VAR_T)
    ref_rel = rel_max(first.state[:REF_LANES], ref.state)
    check(ref_rel <= VAR_REF_RTOL, f"config 4 vs the CPU run: {ref_rel}")
    # one step() of the batch: kernel B2
    zero_launches()
    first.step()
    torch.cuda.synchronize()
    paths["var_step"] = dict(jk.LAUNCHES)
    check(paths["var_step"]["jet"] == 1, "config 4: step() launched "
          f"{paths['var_step']}")
    line = dict(vsys_build_s=build_s, W=tape.width, n_eq=tape.n_eq,
                layout=jk.layout_report(tape), kernels=par, **runs,
                scalar_lane0=dict(max_rel=sc_rel, bit_equal=bool(
                    np.array_equal(ts.state, lane0)),
                    launches=paths["var_scalar_pcr3bp"]),
                cpu_ref_max_rel=ref_rel, nvidia_smi=smi)
    return par, paths, line


def cr3bp_lanes(B):
    """Lanes about a bound CR3BP orbit, the PCR3BP's initial conditions
    lifted to 3-D: each coordinate perturbed by 1e-3 N(0, 1) (rng 1)."""
    rng = np.random.default_rng(1)
    return CR3BP_IC[None] + 1e-3 * rng.standard_normal((B, 6))


def var_cr3bp(dev, order):
    """Phase 22 (b): the CR3BP at order 2 (1,355 columns) on kernel B3:
    B3 against its twin, the slice, and the Taylor map's convergence
    against direct integrations of the displaced lanes."""
    f64 = dict(dtype=torch.float64, device=dev)
    vsys = ht.var_ode_sys(ht.models.cr3bp(mu=VAR_MU), ht.VarArgs.vars, 2)
    arrays = ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(vsys.sys), order))
    rt = jr.RolledTape(arrays, dev)
    rep = jr.layout_report(rt)
    ics = cr3bp_lanes(CR3BP_B)
    full = vsys.initial_state(ics)
    args = (torch.as_tensor(full.T.copy(), **f64),
            torch.zeros((0, CR3BP_B), **f64), torch.zeros(CR3BP_B, **f64))
    tc_k, nrm_k = jr.jet_rolled(rt, *args)
    tc_p, nrm_p = jr.jet_rolled_plain(rt, *args)
    rel = float(per_order_rel(tc_k, tc_p).max())
    nrel = float(((nrm_k - nrm_p).abs() / nrm_p.abs()).max())
    check(rel <= JET_RTOL and nrel <= JET_RTOL,
          f"B3 vs jet_rolled_plain on cr3bp var-o2: {rel}, norms {nrel}")
    t = {"b3": [], "plain": []}
    for which in ("plain", "b3", "b3", "plain"):
        t[which].append(cuda_ms(lambda: jr.jet_rolled(rt, *args), 3)
                        if which == "b3" else
                        cuda_ms(lambda: jr.jet_rolled_plain(rt, *args), 1))
    bnd = rl.bound(rl.jet_flops(arrays) * CR3BP_B,
                   rl.nbytes(*args, rt.ritab, rt.rdtab, tc_k, nrm_k),
                   torch.float64)
    WH, WC, WV, NA, NS = rt.sizes
    kern = dict(timed(t["b3"], t["plain"], bnd), ms_runs=t["b3"],
                max_rel_per_order=rel, norms_max_rel=nrel,
                max_abs_err=float((tc_k - tc_p).abs().max()))
    # the slice
    kw = dict(tol=TOL, high_accuracy=True)
    ta = ht.taylor_adaptive_batch(vsys, ics, device=dev, **kw)
    ta.assert_engine(jet="hy_jet_rolled_f64", propagate_engine="flat")
    cf = jacobi_cf(dev)
    j0 = cf(torch.as_tensor(ics, device=dev))[:, 0]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    oc, _, _, nsteps = ta.propagate_until(CR3BP_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(jk.LAUNCHES)
    check(launches["jet_rolled"] > 0 and all(
        n == 0 for k, n in launches.items() if k != "jet_rolled"),
        f"cr3bp var-o2: kernels launched {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in oc)
          and bool((ta.time == CR3BP_T).all()),
          "cr3bp var-o2: a lane did not land with time_limit")
    st = ta.state
    check(bool(np.isfinite(st).all()), "cr3bp var-o2: non-finite state")
    drift = float(((cf(torch.as_tensor(st[:, :6], device=dev))[:, 0] - j0)
                   .abs() / j0.abs()).max())
    check(drift <= JACOBI_MAX, f"cr3bp var-o2: Jacobi drift {drift}")
    ref = ht.taylor_adaptive_batch(vsys, ics[:CR3BP_REF_LANES], device="cpu",
                                   **kw)
    ref.propagate_until(CR3BP_T)
    ref_rel = rel_max(st[:CR3BP_REF_LANES], ref.state)
    check(ref_rel <= VAR_REF_RTOL, f"cr3bp var-o2 vs the CPU run: {ref_rel}")
    # the Taylor map at d and d / 2 against direct integrations of the
    # displaced lanes (the non-variational system, kernels B1/B2)
    d = TM_D * np.random.default_rng(2).standard_normal(6)
    errs, direct_launches = [], None
    for s in (1.0, 0.5):
        tm = ta.eval_taylor_map(s * d)
        check(np.array_equal(ta.get_tstate(), tm), "get_tstate")
        dr = ht.taylor_adaptive_batch(ht.models.cr3bp(mu=VAR_MU), ics + s * d,
                                      device=dev, **kw)
        zero_launches()
        dr.propagate_until(CR3BP_T)
        direct_launches = direct_launches or dict(jk.LAUNCHES)
        errs.append(np.abs(tm - dr.state).max(1))
    ratio = errs[0] / errs[1]
    check(bool(((ratio >= TM_RATIO[0]) & (ratio <= TM_RATIO[1])).all()),
          f"cr3bp var-o2: the Taylor map's error shrank "
          f"{ratio.min()}-{ratio.max()}x when d halved")
    steps = int(nsteps.sum())
    line = dict(
        W=rt.width, n_eq=rt.n_eq, layout=rep,
        classes=dict(history_rows=WH, aliases=NA, C=WC, V=WV, S=NS),
        lane_bytes=rep.get("lane_bytes"), b3=kern,
        B=CR3BP_B, t_end=CR3BP_T, wall_s=wall, lane_steps=steps,
        steps_per_s=steps / wall, mean_steps_per_lane=steps / CR3BP_B,
        launches=launches, jacobi_drift_max_rel=drift,
        cpu_ref_max_rel=ref_rel,
        taylor_map=dict(d_norm=float(np.linalg.norm(d)),
                        err_max=[float(e.max()) for e in errs],
                        ratio_min=float(ratio.min()),
                        ratio_median=float(np.median(ratio)),
                        ratio_max=float(ratio.max()),
                        direct_launches=direct_launches))
    return kern, {"var_cr3bp_o2": launches}, line


def neural_sys():
    """The 2-[16]-2 tanh network's ODE (weights and biases as params)."""
    x, y = ht.make_vars("x", "y")
    nn = ht.models.ffnn([x, y], [NN_HIDDEN], 2, [ht.tanh, lambda e: e])
    return list(zip([x, y], nn))


def var_neural(dev, order):
    """Phase 22 (c): the neural ODE's sensitivities to its 82 parameters
    on kernel B4: B4 against its twin on the 1,069-column tape, the slice,
    finite differences and the CPU run."""
    sys_ = neural_sys()
    vsys = ht.var_ode_sys(sys_, ht.VarArgs.params, 1)
    n_par = ht.models.ffnn_par_count(2, [NN_HIDDEN], 2)
    w = 0.3 * np.random.default_rng(0).standard_normal(n_par)
    ics = np.random.default_rng(1).uniform(-1.0, 1.0, (NN_B, 2))
    pars = np.tile(w, (NN_B, 1))
    tape = jp.PhaseTape(ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(vsys.sys), order)), dev)
    full = vsys.initial_state(ics, pars=pars)
    tc0 = seeded_buffer(tape, full, pars, np.zeros(NN_B), dev)
    tck, tcp = jp.phase(tape, tc0.clone(), 1), jp.phase_plain(tape,
                                                              tc0.clone(), 1)
    rel = float(per_order_rel(tck.permute(1, 0, 2),
                              tcp.permute(1, 0, 2)).max())
    nk, npl = jk._norms(tape, tck), jk._norms(tape, tcp)
    nrel = float(((nk - npl).abs().amax(1) / npl.abs().amax(1)).max())
    check(rel <= JET_RTOL and nrel <= JET_RTOL,
          f"B4 vs phase_plain on the neural ODE: {rel}, norms {nrel}")
    a, b = tc0.clone(), tc0.clone()
    t = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        t[which].append(graph_ms(lambda: jp.phase(tape, a, 1), 10)
                        if which == "kernel" else
                        cuda_ms(lambda: jp.phase_plain(tape, b, 1), 1))
    bnd = rl.bound(rl.phase_flops(tape.arrays, 1) * NN_B,
                   rl.phase_bytes(tape.arrays, NN_B, 1, 8)
                   + rl.nbytes(tape.itab, tape.dtab), torch.float64)
    shape = jp.layout_report(tape, NN_B)
    kern = dict(timed(t["kernel"], t["plain"], bnd), ms_runs=t["kernel"],
                max_rel_per_order=rel, norms_max_rel=nrel, shape=shape,
                max_abs_err=float((tck - tcp).abs().max()))
    # the slice
    kw = dict(tol=TOL, high_accuracy=True)
    ta = ht.taylor_adaptive_batch(vsys, ics, pars=pars, device=dev, **kw)
    ta.assert_engine(jet="hy_phase_f64", propagate_engine="flat")
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    oc, _, _, nsteps = ta.propagate_until(NN_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(jk.LAUNCHES)
    check(launches["phase"] > 0 and all(
        n == 0 for k, n in launches.items() if k != "phase"),
        f"neural ODE: kernels launched {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in oc)
          and bool((ta.time == NN_T).all()),
          "neural ODE: a lane did not land with time_limit")
    st = ta.state
    check(bool(np.isfinite(st).all()), "neural ODE: non-finite state")
    # central differences over NN_FD_PARS parameters on NN_FD_LANES lanes,
    # one batch of the plain network's ODE (kernel B4 too)
    js = np.linspace(0, n_par - 1, NN_FD_PARS).astype(int)
    L = NN_FD_LANES
    fd_st = np.tile(ics[:L], (2 * len(js), 1))
    fd_pars = np.tile(w, (2 * len(js) * L, 1))
    for k, j in enumerate(js):
        fd_pars[2 * k * L:(2 * k + 1) * L, j] += NN_FD_H
        fd_pars[(2 * k + 1) * L:(2 * k + 2) * L, j] -= NN_FD_H
    fd = ht.taylor_adaptive_batch(sys_, fd_st, pars=fd_pars, device=dev, **kw)
    zero_launches()
    fd.propagate_until(NN_T)
    fd_launches = dict(jk.LAUNCHES)
    fs = fd.state.reshape(len(js), 2, L, 2)
    fd_sens = (fs[:, 0] - fs[:, 1]) / (2 * NN_FD_H)  # (pars, lanes, comps)
    var_sens = np.stack([st[:L, ta.get_vslice(1, c)][:, js]
                         for c in range(2)], 2).transpose(1, 0, 2)
    fd_rel = float((np.abs(var_sens - fd_sens).max(0)
                    / np.abs(fd_sens).max(0)).max())
    check(fd_rel <= NN_FD_RTOL, f"neural ODE: sensitivities against central "
          f"differences {fd_rel}")
    ref = ht.taylor_adaptive_batch(vsys, ics[:REF_LANES],
                                   pars=pars[:REF_LANES], device="cpu", **kw)
    ref.propagate_until(NN_T)
    ref_rel = rel_max(st[:REF_LANES], ref.state)
    check(ref_rel <= NN_REF_RTOL, f"neural ODE vs the CPU run: {ref_rel}")
    steps = int(nsteps.sum())
    line = dict(W=tape.width, n_eq=tape.n_eq, n_pars=tape.n_pars,
                shape=shape, b4=kern, B=NN_B, t_end=NN_T, wall_s=wall,
                lane_steps=steps, steps_per_s=steps / wall,
                mean_steps_per_lane=steps / NN_B, launches=launches,
                fd=dict(params=js.tolist(), lanes=L, h=NN_FD_H,
                        max_rel=fd_rel, launches=fd_launches),
                cpu_ref_max_rel=ref_rel)
    return kern, {"var_neural_ode": launches}, line


def cfunc_scale(dev):
    """Phase 22 (d): the port's cfunc on ``CF_N`` points on the card and
    on the CPU: the CR3BP's Jacobi constant, the outer Solar System's
    energy, the Jacobi constant with mu a parameter of each point, and the
    rotating frame's positions in the inertial one at each point's time."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(7)
    x, y = ht.make_vars("x", "y")
    t, mu = ht.time, ht.par[0]
    cases = {
        "jacobi": ([ht.models.cr3bp_jacobi(mu=VAR_MU)],
                   ["x", "y", "z", "px", "py", "pz"],
                   rng.uniform(-1.0, 1.0, (CF_N, 6)), {}),
        "outer_ss_energy": (
            [ht.models.nbody_energy(6, masses=MASSES, Gconst=GCONST)],
            [v for v, _ in nbody(6, masses=MASSES, Gconst=GCONST)],
            IC[None] * (1.0 + 1e-3 * rng.standard_normal((CF_N, 36))), {}),
        "jacobi_pars": ([ht.models.cr3bp_jacobi(mu=mu)],
                        ["x", "y", "z", "px", "py", "pz"],
                        rng.uniform(-1.0, 1.0, (CF_N, 6)),
                        {"pars": rng.uniform(0.001, 0.5, (CF_N, 1))}),
        "inertial_time": ([x * ht.cos(t) - y * ht.sin(t),
                           x * ht.sin(t) + y * ht.cos(t)], ["x", "y"],
                          rng.uniform(-1.0, 1.0, (CF_N, 2)),
                          {"time": rng.uniform(0.0, 100.0, CF_N)}),
    }
    res = {}
    for name, (fns, vars_, pts, kw) in cases.items():
        cf = ht.make_cfunc(fns, vars=vars_, device=dev)
        cpu = ht.make_cfunc(fns, vars=vars_, device="cpu")
        args = {k: torch.as_tensor(v, device=dev) for k, v in kw.items()}
        pts_d = torch.as_tensor(pts, device=dev)
        out = cf(pts_d, **args)
        want = cpu(pts, **kw)
        check(tuple(out.shape) == (CF_N, cf.n_outs)
              and bool(torch.isfinite(out).all()), f"cfunc {name}: output")
        r = rel_max(out.cpu(), want)
        check(r <= CF_RTOL, f"cfunc {name} on the card vs the CPU: {r}")
        ms = [cuda_ms(lambda: cf(pts_d, **args), 3) for _ in range(2)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(CF_PROFILE_CALLS):
                cf(pts_d, **args)
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        copies = sum(1 for e in ev if "memcpy" in e.name.lower()
                     or "memset" in e.name.lower())
        res[name] = dict(
            n=CF_N, n_ops=len(cf.dc.ops), max_rel=r,
            bit_equal=bool(torch.equal(out.cpu(), want)), ms_runs=ms,
            evals_per_s=CF_N / (min(ms) / 1e3),
            # None where the profiler reported no device event at all
            device_kernels_per_call=(len(ev) - copies) / CF_PROFILE_CALLS
            if ev else None,
            device_copies_per_call=copies / CF_PROFILE_CALLS if ev else None)
    # where the card and the CPU part: each side's sqrt against numpy's,
    # which is correctly rounded
    x = rng.uniform(0.0, 10.0, CF_N)
    exact = torch.as_tensor(np.sqrt(x))
    res["sqrt_differs_from_numpy"] = dict(
        cpu=float((torch.sqrt(torch.as_tensor(x)) != exact).double()
                  .mean()),
        card=float((torch.sqrt(torch.as_tensor(x, device=dev)).cpu()
                    != exact).double().mean()))
    return res


def var_paths(dev, smi, order):
    """Phase 22: variational systems and compiled functions on the card.
    Returns each kernel's row additions (errors and times on its
    variational tape) and the launches on each of the phase's paths."""
    b12, paths, line_a = var_config4(dev, smi, order)
    say("22a", **line_a)
    b3, p_b, line_b = var_cr3bp(dev, order)
    say("22b", nvidia_smi=smi, **line_b)
    b4, p_c, line_c = var_neural(dev, order)
    say("22c", nvidia_smi=smi, **line_c)
    cf = cfunc_scale(dev)
    say("22d", nvidia_smi=smi, **cf)
    return dict(jet=b12["jet"], prop=b12["prop"], jet_rolled=b3,
                phase=b4), {**paths, **p_b, **p_c}


C5_B = 10_240  # geopot_bench.py's batch
C5_T = 86_400.0  # one day
C5_B_SMALL = 1_024  # (b) degree 10 and (c) the drag ODE
C5_REF_T = 5_600.0  # about one orbit: (b)'s and (c)'s CPU reference
C5_REF_LANES = 2
C5_WARM_T = 600.0
C5_PROFILE_T = 8_640.0  # a tenth of the day under the profiler
C5_FAR = 1e7  # a B1 chunk's time to go: no lane nears it in 64 steps
SGP4_N = 16_384  # sgp4_bench.py's population and epochs
SGP4_EPOCHS = 32
SGP4_REF_SATS = 64
SGP4_DIFF_SATS = 1_024
SGP4_RTOL = 1e-12
SGP4_PROFILE_CALLS = 5
LP_N = 2 ** 20
#: ``kepDE``'s last bits grow with |DE| (tests/test_torch_earth_models.py)
LP_RTOL = 1e-13
#: B2-B4 against their twins per order on the config-5 tapes: their
#: dependency chains run deep (the V/W recursion two to three levels a
#: degree, then sums of terms of both signs; the drag's network and
#: exponential profile), and the twins' and the kernels' summation
#: orders part by more ulps there than on the other tapes (degree 4 at
#: 10,240 lanes on an H100: 1.18e-13)
C5_JET_RTOL = 1e-12


def energy_cf(deg, dev):
    """The geopotential's energy ``0.5 |v|^2 - U`` as the port's cfunc on
    ``dev``: a function of states (B, 6), arrays or tensors on ``dev``,
    per lane."""
    e, vs = geopot_energy(ht, deg)
    cf = ht.make_cfunc([e], vars=vs, device=dev)
    return lambda st: cf(st)[:, 0]


def c5_arrays(sys_, order):
    """The plan arrays of a config-5 tape, as the kernels take them."""
    return ht.plan_to_arrays(build_plan(ht.taylor_decompose_sys(sys_), order))


def profiled(make, t_end, kernel, run=None):
    """``make()``'s ``propagate_until(t_end)`` (or ``run(integrator)``)
    timed without the profiler, then again under ``torch.profiler``: the
    device's busy and idle shares and ``kernel``'s (a substring of its
    name) share of the busy time."""
    from torch.profiler import ProfilerActivity, profile
    run = run or (lambda t: t.propagate_until(t_end))
    wall = timed_call(make, run)[2]
    tp = make()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(tp)
        torch.cuda.synchronize()
    dev_ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e6
    kern_ev = [e for e in dev_ev if kernel in e.name]
    kern = sum(e.time_range.elapsed_us() for e in kern_ev) / 1e6
    return dict(t_end=t_end, wall_s=wall, device_events=len(dev_ev),
                kernel_events=len(kern_ev),
                device_busy_s=busy if dev_ev else None,
                device_idle_share=1.0 - busy / wall if dev_ev else None,
                kernel_share_of_busy=kern / busy if dev_ev else None)


#: lane-steps/s of the paths a later phase compares with (phase 23 (c)'s
#: drag ODE beside phase 25's full model)
RATES = {}


def only(launches, *keys):
    """Whether the kernels ``keys`` and no other were launched."""
    return all((n > 0) == (k in keys) for k, n in launches.items())


def geopot_ensemble(dev, smi, order):
    """Phase 23 (a): ``geopot_bench.py``'s 10,240 lanes at degree 4
    through ``ensemble_propagate_until`` of a scalar template for one
    day on kernels B1/B2: the energy drift of every lane, the raw batch
    bit for bit, 4 lanes against the CPU, B1/B2 against their twins on
    the tape and B1's time a chunk, the device's idle share."""
    sys4 = geopot_sys(ht, 4)
    ics = geopot_lanes(C5_B, 0)
    kw = dict(tol=TOL, high_accuracy=True)
    ta = ht.taylor_adaptive(sys4, GEOPOT_IC, device=dev, **kw)
    ta.assert_engine(jet="hy_jet_f64", propagate_engine="fused",
                     prop="hy_prop_f64")
    en = energy_cf(4, dev)
    ht.ensemble_propagate_until(ta, C5_WARM_T, CHUNK, {"state": ics[:CHUNK]})
    e0 = en(ics)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    res = ht.ensemble_propagate_until(ta, C5_T, C5_B, {"state": ics})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(jk.LAUNCHES)
    check(only(launches, "jet", "prop"),
          f"config 5 (a): kernels launched {launches}")
    check(bool((res["outcome"] == int(ht.TaylorOutcome.time_limit)).all()
               and (res["time"] == C5_T).all()),
          "config 5 (a): an instance did not land with time_limit")
    st = res["state"]
    check(st.device.type == dev.type and bool(torch.isfinite(st).all()),
          "config 5 (a): bad final state")
    drift = float(((en(st) - e0).abs() / e0.abs()).max())
    check(drift <= DRIFT_MAX, f"config 5 (a): energy drift {drift}")
    raw, rres, raw_wall = timed_call(
        lambda: ht.taylor_adaptive_batch(sys4, ics, device=dev, **kw),
        lambda t: t.propagate_until(C5_T))
    same = bool(np.array_equal(st.cpu().numpy(), raw.state) and np.array_equal(
        res["nsteps"].cpu().numpy(), np.asarray(rres[3])))
    check(same, "config 5 (a): the ensemble differs from the raw batch")
    ref = ht.taylor_adaptive_batch(sys4, ics[:REF_LANES], device="cpu", **kw)
    ref.propagate_until(C5_T)
    ref_rel = rel_max(st[:REF_LANES].cpu(), ref.state)
    check(ref_rel <= REF_RTOL, f"config 5 (a) vs the CPU run: {ref_rel}")
    tape = jk.JetTape(c5_arrays(sys4, order), dev)
    par = jet_parity(tape, ics, dev, what="geopotential degree 4",
                     jet_rtol=C5_JET_RTOL, far=C5_FAR)
    prof = profiled(lambda: ht.taylor_adaptive_batch(sys4, ics, device=dev,
                                                     **kw),
                    C5_PROFILE_T, "prop_kernel")
    steps = int(res["nsteps"].sum())
    line = dict(
        B=C5_B, t_end=C5_T, W=tape.width, n_ops=len(raw.decomposition.ops),
        wall_s=wall, lane_steps=steps, steps_per_s=steps / wall,
        mean_steps_per_lane=steps / C5_B, launches=launches,
        energy_drift_max_rel=drift, raw_batch_bit_equal=same,
        raw_batch_wall_s=raw_wall, cpu_ref_max_rel=ref_rel,
        b1_ms_a_chunk=par["prop"]["ms"], kernels=par, profile=prof,
        nvidia_smi=smi)
    return par, {"config5_geopot_ensemble": launches}, line


def geopot_deg10(dev, smi, order):
    """Phase 23 (b): degree 10 (1,248 columns) on 1,024 of (a)'s lanes for
    one day on kernel B3, then the same lanes through the fused B1 route
    (``ROLLED_MIN_WIDTH`` raised while the integrator is built, ROADMAP
    A.16), timed beside it and held to its states; B3 against its twin
    on the tape."""
    sys10 = geopot_sys(ht, 10)
    ics = geopot_lanes(C5_B, 0)[:C5_B_SMALL]
    kw = dict(tol=TOL, high_accuracy=True)
    en = energy_cf(10, dev)
    ta = ht.taylor_adaptive_batch(sys10, ics, device=dev, **kw)
    ta.assert_engine(jet="hy_jet_rolled_f64", propagate_engine="flat")
    e0 = en(ics)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    first = ta.propagate_until(C5_REF_T)[3]
    st_ref_t = ta.state[:C5_REF_LANES]
    oc, _, _, nsteps = ta.propagate_until(C5_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(jk.LAUNCHES)
    check(only(launches, "jet_rolled"),
          f"config 5 (b): kernels launched {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in oc)
          and bool((ta.time == C5_T).all()),
          "config 5 (b): a lane did not land with time_limit")
    st = ta.state
    check(bool(np.isfinite(st).all()), "config 5 (b): non-finite state")
    drift = float(((en(st) - e0).abs() / e0.abs()).max())
    check(drift <= DRIFT_MAX, f"config 5 (b): energy drift {drift}")
    ref = ht.taylor_adaptive_batch(sys10, ics[:C5_REF_LANES], device="cpu",
                                   **kw)
    ref.propagate_until(C5_REF_T)
    ref_rel = rel_max(st_ref_t, ref.state)
    check(ref_rel <= REF_RTOL, f"config 5 (b) vs the CPU run: {ref_rel}")
    # B3 against its twin on the tape, and its time
    arrays = c5_arrays(sys10, order)
    rt = jr.RolledTape(arrays, dev)
    f64 = dict(dtype=torch.float64, device=dev)
    args = (torch.as_tensor(ics.T.copy(), **f64),
            torch.zeros((0, C5_B_SMALL), **f64),
            torch.zeros(C5_B_SMALL, **f64))
    tc_k, nrm_k = jr.jet_rolled(rt, *args)
    tc_p, nrm_p = jr.jet_rolled_plain(rt, *args)
    rel = float(per_order_rel(tc_k, tc_p).max())
    nrel = float(((nrm_k - nrm_p).abs() / nrm_p.abs()).max())
    check(rel <= C5_JET_RTOL and nrel <= C5_JET_RTOL,
          f"B3 vs jet_rolled_plain on degree 10: {rel}, norms {nrel}")
    t = {"b3": [], "plain": []}
    for which in ("plain", "b3", "b3", "plain"):
        t[which].append(cuda_ms(lambda: jr.jet_rolled(rt, *args), 3)
                        if which == "b3" else
                        cuda_ms(lambda: jr.jet_rolled_plain(rt, *args), 1))
    bnd = rl.bound(rl.jet_flops(arrays) * C5_B_SMALL,
                   rl.nbytes(*args, rt.ritab, rt.rdtab, tc_k, nrm_k),
                   torch.float64)
    kern = dict(timed(t["b3"], t["plain"], bnd), ms_runs=t["b3"],
                max_rel_per_order=rel, norms_max_rel=nrel,
                layout=jr.layout_report(rt),
                max_abs_err=float((tc_k - tc_p).abs().max()))
    fused = fused_route(sys10, ics, st, dev, C5_T, "config 5 (b)")
    steps = int(first.sum() + nsteps.sum())
    line = dict(B=C5_B_SMALL, t_end=C5_T, W=rt.width,
                n_ops=len(ta.decomposition.ops), wall_s=wall,
                lane_steps=steps, steps_per_s=steps / wall,
                mean_steps_per_lane=steps / C5_B_SMALL, launches=launches,
                energy_drift_max_rel=drift, cpu_ref_t=C5_REF_T,
                cpu_ref_max_rel=ref_rel, b3=kern, fused_route=fused,
                nvidia_smi=smi)
    return kern, {"config5_deg10": launches}, line, fused



def drag_ode(dev, smi, order):
    """Phase 23 (c): the drag ODE (``tools/cases.py`` ``drag_sys``: the
    degree-4 geopotential plus NRLMSISE-00 thermoNET drag as
    ``models/eo_dynamics.py`` ``_drag_acc`` writes it, 2,388 columns) on
    1,024 lanes with per-lane space weather and ballistic coefficients
    for one day on kernel B4, order 0 in torch.  Two simplifications keep
    it within the port's models: no EOP/SW rotations (ROADMAP A.15), so
    the atmosphere rests in the body-fixed frame (``vrel = v``, with the
    ``veps`` regularisation kept); ``h, lat, lon = cart2geo(r, R_eq =
    A_EARTH / 1e3)`` and the indices are parameters, ``time / 86400``
    the day fraction.  Every lane loses energy over the day (drag only
    dissipates), 2 lanes agree with the CPU over the first 5,600 s; B4
    against its twin on the tape; the device's idle share."""
    sys_ = drag_sys(ht, 4)
    ics = geopot_lanes(C5_B, 0)[:C5_B_SMALL]
    pars = drag_pars(C5_B_SMALL, 1)
    kw = dict(tol=TOL, high_accuracy=True)
    en = energy_cf(4, dev)
    ta = ht.taylor_adaptive_batch(sys_, ics, pars=pars, device=dev, **kw)
    ta.assert_engine(jet="hy_phase_f64", propagate_engine="flat")
    e0 = en(ics)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    first = ta.propagate_until(C5_REF_T)[3]
    st_ref_t = ta.state[:C5_REF_LANES]
    oc, _, _, nsteps = ta.propagate_until(C5_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(jk.LAUNCHES)
    check(only(launches, "phase"),
          f"config 5 (c): kernels launched {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in oc)
          and bool((ta.time == C5_T).all()),
          "config 5 (c): a lane did not land with time_limit")
    st = ta.state
    check(bool(np.isfinite(st).all()), "config 5 (c): non-finite state")
    de = en(st) - e0
    check(bool((de < 0).all()), "config 5 (c): a lane gained energy")
    ref = ht.taylor_adaptive_batch(sys_, ics[:C5_REF_LANES],
                                   pars=pars[:C5_REF_LANES], device="cpu",
                                   **kw)
    ref.propagate_until(C5_REF_T)
    ref_rel = rel_max(st_ref_t, ref.state)
    check(ref_rel <= REF_RTOL, f"config 5 (c) vs the CPU run: {ref_rel}")
    # B4 against its twin on the tape from lo = 1, and its time
    tape = jp.PhaseTape(c5_arrays(sys_, order), dev)
    tc0 = seeded_buffer(tape, ics, pars, np.zeros(C5_B_SMALL), dev)
    tck, tcp = jp.phase(tape, tc0.clone(), 1), jp.phase_plain(tape,
                                                              tc0.clone(), 1)
    rel = float(per_order_rel(tck.permute(1, 0, 2),
                              tcp.permute(1, 0, 2)).max())
    nk, npl = jk._norms(tape, tck), jk._norms(tape, tcp)
    nrel = float(((nk - npl).abs().amax(1) / npl.abs().amax(1)).max())
    check(rel <= C5_JET_RTOL and nrel <= C5_JET_RTOL,
          f"B4 vs phase_plain on the drag ODE: {rel}, norms {nrel}")
    a, b = tc0.clone(), tc0.clone()
    t = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        t[which].append(graph_ms(lambda: jp.phase(tape, a, 1), 10)
                        if which == "kernel" else
                        cuda_ms(lambda: jp.phase_plain(tape, b, 1), 1))
    bnd = rl.bound(rl.phase_flops(tape.arrays, 1) * C5_B_SMALL,
                   rl.phase_bytes(tape.arrays, C5_B_SMALL, 1, 8)
                   + rl.nbytes(tape.itab, tape.dtab), torch.float64)
    shape = jp.layout_report(tape, C5_B_SMALL)
    kern = dict(timed(t["kernel"], t["plain"], bnd), ms_runs=t["kernel"],
                max_rel_per_order=rel, norms_max_rel=nrel, shape=shape,
                max_abs_err=float((tck - tcp).abs().max()))
    prof = profiled(lambda: ht.taylor_adaptive_batch(
        sys_, ics, pars=pars, device=dev, **kw), C5_PROFILE_T,
        "phase_kernel")
    steps = int(first.sum() + nsteps.sum())
    RATES["config5_drag"] = steps / wall
    line = dict(B=C5_B_SMALL, t_end=C5_T, W=tape.width, n_eq=tape.n_eq,
                n_ops=len(ta.decomposition.ops), n_pars=tape.n_pars,
                wall_s=wall, lane_steps=steps, steps_per_s=steps / wall,
                mean_steps_per_lane=steps / C5_B_SMALL, launches=launches,
                energy_change_rel=dict(
                    min=float((de / e0.abs()).min()),
                    max=float((de / e0.abs()).max())),
                cpu_ref_t=C5_REF_T, cpu_ref_max_rel=ref_rel, b4=kern,
                profile=prof, nvidia_smi=smi)
    return kern, {"config5_drag": launches}, line


def sgp4_batch(dev, smi):
    """Phase 23 (d): ``sgp4_bench.py``'s 16,384 satellites at 32 epochs
    over a day through ``SGP4Propagator`` on the card: the Spacetrack
    Report #3 vectors, 64 satellites against the CPU, ``diff_order=1`` on
    1,024 satellites against the CPU, dates against times; the
    satellite-epochs/s and the device kernels a call."""
    from torch.profiler import ProfilerActivity, profile
    from heyoka_tpu_torch.utils import cal_to_jd, parse_tle
    gpe = parse_tle(*SGP4_TLE).reshape(9, 1)
    rep = ht.models.SGP4Propagator(gpe, device=dev)
    out = rep(REPORT3[:, :1].copy())
    check(out.device.type == dev.type, "sgp4: result not on the card")
    out = out.cpu().numpy()[:, 0]
    rep_pos = float(np.abs(out[:, :3] - REPORT3[:, 1:4]).max())
    rep_vel = float(np.abs(out[:, 3:6] - REPORT3[:, 4:7]).max())
    check(rep_pos <= 2e-2 and rep_vel <= 2e-5 and (out[:, 6] == 0).all(),
          f"sgp4: Report #3 vectors {rep_pos} km, {rep_vel} km/s")
    g = sgp4_population(SGP4_N)
    g[7], g[8] = cal_to_jd(2024, 3, 1), 0.25
    tm = np.broadcast_to(np.linspace(0.0, 1440.0, SGP4_EPOCHS)[:, None],
                         (SGP4_EPOCHS, SGP4_N)).copy()
    prop = ht.models.SGP4Propagator(g, device=dev)
    tm_d = torch.as_tensor(tm, device=dev)
    res = prop(tm_d)
    check(tuple(res.shape) == (SGP4_EPOCHS, SGP4_N, 7)
          and bool(torch.isfinite(res).all())
          and bool((res[..., 6] == 0).all()), "sgp4: bad output")
    cpu = ht.models.SGP4Propagator(g[:, :SGP4_REF_SATS].copy(), device="cpu")
    want = cpu(tm[:, :SGP4_REF_SATS].copy())
    ref_rel = rel_max(res[:, :SGP4_REF_SATS].cpu(), want)
    check(ref_rel <= SGP4_RTOL, f"sgp4 vs the CPU run: {ref_rel}")
    # the first derivatives on 1,024 satellites at one epoch each
    n = SGP4_DIFF_SATS
    g1 = g[:, :n].copy()
    t1 = tm[SGP4_EPOCHS // 2, :n].copy()
    p_d = ht.models.SGP4Propagator(g1, diff_order=1, device=dev)
    d_card = p_d(t1)
    d_cpu = ht.models.SGP4Propagator(g1, diff_order=1, device="cpu")(t1)
    d_rel = float((((d_card.cpu() - d_cpu).abs().amax(0))
                   / d_cpu.abs().amax(0).clamp_min(1e-300)).max())
    check(d_rel <= SGP4_RTOL, f"sgp4 diff_order=1 vs the CPU: {d_rel}")
    # UTC dates against the same instants as minutes since the epoch
    jd = np.broadcast_to(g[7], tm.shape)
    res_d = prop(jd=jd, frac=g[8] + tm / 1440.0)
    dates_err = float((res_d - res).abs().amax())
    check(dates_err <= 1e-7, f"sgp4: dates against times {dates_err} km")
    ms = [cuda_ms(lambda: prop(tm_d), 3) for _ in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as pr:
        for _ in range(SGP4_PROFILE_CALLS):
            prop(tm_d)
        torch.cuda.synchronize()
    ev = [e for e in pr.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    d_ms = cuda_ms(lambda: p_d(t1), 1)
    return dict(
        report3_max_err_km=rep_pos, report3_max_err_km_s=rep_vel,
        sats=SGP4_N, epochs=SGP4_EPOCHS, n_ops=len(prop._cf.dc.ops),
        cpu_ref_sats=SGP4_REF_SATS, cpu_ref_max_rel=ref_rel,
        bit_equal_cpu=bool(torch.equal(res[:, :SGP4_REF_SATS].cpu(), want)),
        diff1_sats=n, diff1_max_rel=d_rel, diff1_ms=d_ms,
        dates_max_err_km=dates_err, ms_runs=ms,
        sat_epochs_per_s=SGP4_N * SGP4_EPOCHS / (min(ms) / 1e3),
        device_kernels_per_call=len(ev) / SGP4_PROFILE_CALLS if ev else None,
        nvidia_smi=smi)


def lagrange_points(dev, smi):
    """Phase 23 (e): ``lagrange_prop`` through the cfunc at 2^20 points on
    the card against the CPU: ``kepDE``'s Newton loop on the device.  The
    orbits are bound and far from radial (|r| in [0.8, 1.2], the speed
    0.8-1.15 of the circular one, a radial part up to 0.1; e below ~0.4),
    where the solver converges from its start value: near e = 1 it does
    not in 50 iterations, and two libms' last bits then part."""
    rng = np.random.default_rng(8)
    u = rng.standard_normal((LP_N, 3))
    u /= np.linalg.norm(u, axis=1)[:, None]
    w = np.cross(u, rng.standard_normal((LP_N, 3)))
    w /= np.linalg.norm(w, axis=1)[:, None]
    r = rng.uniform(0.8, 1.2, (LP_N, 1))
    v = (w * rng.uniform(0.8, 1.15, (LP_N, 1))
         + u * rng.uniform(-0.1, 0.1, (LP_N, 1))) / np.sqrt(r)
    pts = np.concatenate([u * r, v], 1)
    tof = rng.uniform(-5.0, 5.0, LP_N)
    fns = ht.models.lagrange_prop(mu=1.0)
    vars_ = ["x0", "y0", "z0", "vx0", "vy0", "vz0"]
    cf = ht.make_cfunc(fns, vars=vars_, device=dev)
    pts_d, tof_d = (torch.as_tensor(a, device=dev) for a in (pts, tof))
    out = cf(pts_d, time=tof_d)
    want = ht.make_cfunc(fns, vars=vars_, device="cpu")(pts, time=tof)
    check(bool(torch.isfinite(out).all()), "lagrange_prop: non-finite")
    r = float((((out.cpu() - want).abs().amax(0))
               / want.abs().amax(0)).max())
    check(r <= LP_RTOL, f"lagrange_prop on the card vs the CPU: {r}")
    ms = [cuda_ms(lambda: cf(pts_d, time=tof_d), 3) for _ in range(2)]
    return dict(n=LP_N, n_ops=len(cf.dc.ops), max_rel=r,
                bit_equal=bool(torch.equal(out.cpu(), want)), ms_runs=ms,
                evals_per_s=LP_N / (min(ms) / 1e3), nvidia_smi=smi)


def config5_paths(dev, smi, order):
    """Phase 23: BASELINE config 5 on the card.  Returns each kernel's
    row additions (error and time on its config-5 tape) and the launches
    on each of the phase's paths."""
    b12, paths, line_a = geopot_ensemble(dev, smi, order)
    say("23a", **line_a)
    b3, p_b, line_b, fused = geopot_deg10(dev, smi, order)
    paths.update(p_b, config5_deg10_fused={
        k: fused["launches"].get(k, 0) for k in jk.LAUNCHES})
    say("23b", **line_b)
    b4, p_c, line_c = drag_ode(dev, smi, order)
    paths.update(p_c)
    say("23c", **line_c)
    say("23d", **sgp4_batch(dev, smi))
    say("23e", **lagrange_points(dev, smi))
    return dict(jet=b12["jet"], prop=b12["prop"], jet_rolled=b3,
                phase=b4), paths


# -- phase 24: the series slice ----------------------------------------------

SER_B = 10_240
SER_B_REF = 256  # benchmarks/vsop2013_cartesian.py's batch
SER_T = 0.02  # centuries: the benchmark's horizon
SER_P9_THRESH = 1e-9  # (a): planet 9's 15 ops, 4,479 terms
SER_ROUTE_THRESH = 1e-7  # (c): the expanded tape has 1,332 u-vars
SER_ROUTE_B = 1_024
SER_ROUTE_T = 0.01  # millennia
SER_REF_LANES = 16
SER_PROFILE_T = 0.004
SER_CF_N = 2 ** 18
SER_CF_REF = 1_024
#: S1 against its twin: each order within this share of the sum of its
#: terms' magnitudes (S1-G's recurrence uses fma, S1-L's products and
#: both kernels' sums over 10^4 terms run in other orders)
SER_RTOL = 1e-13
SER_REF_RTOL = 1e-12
SER_ROUTES_RTOL = 1e-12
#: the position from the cfunc: the series' 1e-13 through cos/sin of U, V
SER_CF_POS_RTOL = 1e-12
ELP_VEC_ATOL = 0.05  # km: tests/test_ephemeris.py:23-40
ELP_VECTORS = np.array([
    (-361605.79234692274, 44981.04302003427, -30693.19198820311, 2469000.5),
    (-363123.49639910535, 35877.2078378671, -33194.68710267386, 2449000.5),
    (-371572.8001113177, 75278.04108874535, -32227.390108194537, 2429000.5),
    (-373885.8585384737, 127397.62026596011, -30039.82215825389, 2409000.5),
    (-346323.78767959465, 206374.952164921, -28496.523303933904, 2389000.5)])


def series_ops(sys_):
    """The series op names of a system's tape, in tape order."""
    return [op.op for op in ht.taylor_decompose_sys(sys_).ops
            if op.op.startswith("trigseries%")]


def s1_run(work, U0, U1, which="both"):
    """Kernel S1 on ``work`` at ``U0``, ``U1`` (n_ser, B): ``(K+1, n_ser,
    B)``, one class alone (``which`` "lin" or "gen") or both."""
    out = U0.new_empty((work.K + 1, U0.shape[0], U0.shape[1]))
    return sj._series_cuda(work, U0, U1, out, range(U0.shape[0]), which)


def s1_twin(splits, U0, U1, K, which):
    """The twin of ``which`` on every series of ``splits``: ``(f, scale)``,
    each ``(K+1, n_ser, B)``."""
    got = [sj._closed_form(sp, U0[i], U1[i], K, True) if which == "lin"
           else sj._recurrence(sp.gen_tab, U0[i], U1[i], K, True)
           if which == "gen" else
           sj.series_jet_plain(sj.tables_on(sp.name, U0.device), U0[i],
                               U1[i], K, True)
           for i, sp in enumerate(splits)]
    return (torch.stack([f for f, _ in got], 1),
            torch.stack([m for _, m in got], 1))


def lin_yardstick(splits, U0, U1, K):
    """Class L of every series by the closed form in a few torch calls a
    series, every (term, lane) pair at once: a multiply and an add for
    the phases (an fma, ``addcmul``, moves a phase of 4e4 rad by an ulp
    and its sin by 7e-12), ``sin`` and ``cos`` of the whole ``(n_L, B)``
    table, two ``matmul`` and the scale ``u1^m / m!`` by ``cumprod`` (the
    yardstick of kernel S1-L, never called by the port)."""
    out = []
    m = torch.arange(1, K + 1, dtype=U0.dtype, device=U0.device)
    for i, sp in enumerate(splits):
        p0 = sp.ph0[:, None] + U0[i][None] * sp.ph1[:, None]
        f = U0.new_empty((K + 1, U0.shape[1]))
        f[0::2] = sp.W[0::2] @ torch.sin(p0)
        if K:
            f[1::2] = sp.W[1::2] @ torch.cos(p0)
        sc = torch.cumprod(torch.cat([torch.ones_like(U1[i][None]),
                                      U1[i][None] / m[:, None]]), 0)
        out.append(f * sc)
    return torch.stack(out, 1)


def s1_check(what, got, again, want, scale):
    """The largest error of ``got`` over ``scale`` (each order's summed
    term magnitudes), checked to ``SER_RTOL``, and two runs' bits."""
    check(bool(torch.isfinite(got).all()), f"S1 {what}: not finite")
    rel = float(((got - want).abs() / torch.where(
        scale > 0, scale, torch.ones_like(scale))).max())
    check(rel <= SER_RTOL, f"S1 {what} vs its twin: {rel}")
    check(torch.equal(got, again), f"S1 {what}: two runs differ")
    return rel, float((got - want).abs().max())


def s1_parity(dev, order):
    """Phase 24 (a): kernel S1's entries against their twins on the 24
    series ops of the complete ELP2000 tape and planet 9's at
    ``SER_P9_THRESH``, at ``SER_B`` lanes: S1-L and S1-G alone on each op,
    then each tape's grouped step; on the ELP2000 step each entry's time,
    its twin's, its bound, and the torch closed form of class L.  Returns
    the two entries' rows of the kernels line, keyed by entry, each with
    its largest error, and the phase's line."""
    rng = np.random.default_rng(24)
    u0 = torch.as_tensor(rng.uniform(-0.5, 0.5, SER_B), device=dev)
    u1 = torch.ones_like(u0)
    K = order
    ops, steps = [], {}
    worst = {"lin": (0.0, 0.0), "gen": (0.0, 0.0)}

    def keep(cls, rel, err):
        worst[cls] = (max(worst[cls][0], rel), max(worst[cls][1], err))

    for which, names in (("elp", series_ops(elp_sys(ht, 0.0))),
                         ("p9", series_ops(p9_sys(ht, SER_P9_THRESH)))):
        tabs = [sj.tables_on(nm, dev) for nm in names]
        splits = [sj.split_of(t, K) for t in tabs]
        for tab, sp in zip(tabs, splits):
            work = sj.work_of((tab,), K)
            row = dict(tape=which, n=tab.n, n_lin=int(sp.lin.size),
                       n_gen=int(sp.gen.size), d=tab.d, q=tab.q)
            for cls, n in (("lin", sp.lin.size), ("gen", sp.gen.size)):
                if not n:
                    continue
                got = s1_run(work, u0[None], u1[None], cls)
                again = s1_run(work, u0[None], u1[None], cls)
                torch.cuda.synchronize()
                rel, err = s1_check(f"{cls} on {which} {tab.name}", got,
                                    again, *s1_twin([sp], u0[None],
                                                    u1[None], K, cls))
                keep(cls, rel, err)
                row[f"{cls}_max_err_of_scale"] = rel
            ops.append(row)
        # the grouped step: every op of the tape in one work list
        n = len(tabs)
        U0, U1 = u0.expand(n, -1).contiguous(), u1.expand(n, -1).contiguous()
        work = sj.work_of(tabs, K)
        zero_launches()
        got = s1_run(work, U0, U1)
        launches = {k: jk.LAUNCHES[k] for k in ("series_lin", "series_gen")}
        again = s1_run(work, U0, U1)
        torch.cuda.synchronize()
        n_gen = sum(sp.gen.size for sp in splits)
        check(launches == {"series_lin": 1, "series_gen": int(n_gen > 0)},
              f"S1 {which} step: launches {launches}")
        want, scale = s1_twin(splits, U0, U1, K, "both")
        rel, err = s1_check(f"{which} step", got, again, want, scale)
        for cls in ("lin", "gen"):
            keep(cls, rel, err)
        step = dict(launches=launches, max_err_of_scale=rel,
                    lin=dict(terms=int(sum(sp.lin.size for sp in splits))),
                    gen=dict(terms=int(n_gen)))
        if which == "elp":
            for cls in ("lin", "gen"):
                ms = [cuda_ms(lambda: s1_run(work, U0, U1, cls), 3)
                      for _ in range(2)]
                plain = cuda_ms(lambda: s1_twin(splits, U0, U1, K, cls), 1,
                                warmup=False)
                step[cls].update(ms_runs=ms, ms=sum(ms) / 2, plain_ms=plain)
            ms = [cuda_ms(lambda: s1_run(work, U0, U1), 3)
                  for _ in range(2)]
            step.update(ms_runs=ms, ms=sum(ms) / 2)
            yard = lin_yardstick(splits, U0, U1, K)
            lw, ls = s1_twin(splits, U0, U1, K, "lin")
            yrel = float(((yard - lw).abs() / torch.where(
                ls > 0, ls, torch.ones_like(ls))).max())
            check(yrel <= SER_RTOL, f"S1-L's yardstick vs the twin: {yrel}")
            del yard, lw, ls
            step["lin"].update(
                library_ms=cuda_ms(lambda: lin_yardstick(splits, U0, U1, K),
                                   1), library_max_err_of_scale=yrel)
            # the bounds: class L on the FP64 units and tensor cores, class
            # G and (before the split) every term by the recurrence
            nb = [rl.series_bytes(n_, t.d, t.q, K, SER_B) for t, n_ in
                  zip(tabs, (sp.lin.size for sp in splits))]
            fl = [rl.series_lin_flops(sp.lin.size, K) for sp in splits]
            step["lin"].update(rl.bound_by_type(
                {k: SER_B * sum(f[k] for f in fl) for k in fl[0]},
                sum(nb)))
            step["gen"].update(rl.bound(
                SER_B * sum(rl.series_flops(sp.gen.size, t.d, t.q, K)
                            for t, sp in zip(tabs, splits)),
                sum(rl.series_bytes(sp.gen.size, t.d, t.q, K, SER_B)
                    for t, sp in zip(tabs, splits)), torch.float64))
            rec = [rl.bound(SER_B * rl.series_flops(t.n, t.d, t.q, K),
                            rl.series_bytes(t.n, t.d, t.q, K, SER_B),
                            torch.float64) for t in tabs]
            step.update(
                bound_ms=step["lin"]["bound_ms"] + step["gen"]["bound_ms"],
                recurrence_bound_ms=sum(b["bound_ms"] for b in rec))
        steps[which] = step
    elp = steps["elp"]
    rows = {}
    for entry, cls in zip(sj.ENTRIES, ("lin", "gen")):
        e = elp[cls]
        rows[entry] = (worst[cls][1], dict(
            ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=e.get("library_ms"),
            x_bound=e["ms"] / e["bound_ms"], ms_runs=e["ms_runs"],
            terms=e["terms"], lanes=SER_B, order=K,
            max_err_of_scale=worst[cls][0],
            elp2000_step_ms=elp["ms"], elp2000_step_bound_ms=elp["bound_ms"],
            recurrence_bound_ms_a_step=elp["recurrence_bound_ms"],
            yardstick="torch closed form (mul, add, sin, cos, 2 matmul)"
            if cls == "lin" else None))
    return rows, dict(B=SER_B, K=K, ops=ops, steps=steps)


def elp_batch(sys_, t0, dev):
    return ht.taylor_adaptive_batch(sys_, np.zeros((t0.size, 3)), time=t0,
                                    tol=TOL, device=dev)


def elp_complete(dev, smi, order):
    """Phase 24 (b): the complete ELP2000 ODE on ``SER_B`` lanes through
    S1 and B4 only; B4 against its twin on the tape and its time a launch;
    the idle share; the same at ``SER_B_REF`` lanes."""
    sys_ = elp_sys(ht, 0.0)
    t0 = series_times(SER_B, 0)
    ta = elp_batch(sys_, t0, dev)
    ta.assert_engine(jet="hy_phase_f64", propagate_engine="flat",
                     series=sj.REPORT)
    torch.cuda.synchronize()
    zero_launches()
    w0 = time.perf_counter()
    res = ta.propagate_for(SER_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    launches = dict(jk.LAUNCHES)
    check(only(launches, "phase", "series_lin", "series_gen"),
          f"ELP2000: kernels launched {launches}")
    # one jet a step: each S1 entry once with B4
    check(launches["series_lin"] == launches["series_gen"]
          == launches["phase"], f"ELP2000: S1 launches {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in res[0]),
          "ELP2000: a lane did not end with time_limit")
    check(bool(np.array_equal(ta.time, t0 + SER_T)),
          "ELP2000: a lane missed its target")
    check(bool(np.isfinite(ta.state).all()), "ELP2000: bad final state")
    ref = elp_batch(sys_, t0[:SER_REF_LANES], "cpu")
    ref.propagate_for(SER_T)
    ref_rel = rel_max(ta.state[:SER_REF_LANES], ref.state)
    check(ref_rel <= SER_REF_RTOL, f"ELP2000 vs the CPU run: {ref_rel}")
    steps = int(np.asarray(res[3]).sum())
    # B4 on the tape at the main width: against its twin, its time
    tape = ta._jtape
    tc = jk._seed_plain(tape, *lane_tensors(np.zeros((SER_B, 3)),
                                            np.zeros((SER_B, 0)), t0, dev))
    ser = jp.order0(tape, tc)
    tc_k = jp.phase(tape, tc.clone(), 1, ser)
    tc_p = jp.phase_plain(tape, tc.clone(), 1, ser)
    b4_rel = float(per_order_rel(tc_k.permute(1, 0, 2),
                                 tc_p.permute(1, 0, 2)).max())
    check(b4_rel <= JET_RTOL, f"B4 vs its twin on ELP2000: {b4_rel}")
    work = tc.clone()
    b4_ms = cuda_ms(lambda: jp.phase(tape, work, 1, ser), 5)
    b4_plain = cuda_ms(lambda: jp.phase_plain(tape, work, 1, ser), 1)
    b4_bnd = rl.bound(SER_B * rl.phase_flops(tape.arrays, 1),
                      rl.phase_bytes(tape.arrays, SER_B, 1, 8)
                      + rl.nbytes(ser), torch.float64)
    prof = profiled(lambda: elp_batch(sys_, t0, dev), None, "series_",
                    run=lambda t: t.propagate_for(SER_PROFILE_T))
    small, sres, swall = timed_call(
        lambda: elp_batch(sys_, t0[:SER_B_REF], dev),
        lambda t: t.propagate_for(SER_T))
    line = dict(
        B=SER_B, t_span=SER_T, W=tape.width, n_series=tape.n_ser,
        n_terms=sum(tab.n for _, _, tab in tape.series), wall_s=wall,
        lane_steps=steps, mean_steps_per_lane=steps / SER_B,
        lane_steps_per_s=steps / wall, launches=launches,
        cpu_ref_lanes=SER_REF_LANES, cpu_ref_max_rel=ref_rel,
        b4=dict(ms=b4_ms, plain_ms=b4_plain, max_rel_per_order=b4_rel,
                **b4_bnd, layout=jp.layout_report(tape, SER_B)),
        profile=prof, b256=dict(
            B=SER_B_REF, wall_s=swall,
            lane_steps_per_s=int(np.asarray(sres[3]).sum()) / swall,
            mean_steps_per_lane=float(np.asarray(sres[3]).mean())),
        nvidia_smi=smi)
    return line, launches, dict(ms=b4_ms, plain_ms=b4_plain,
                                bound_ms=b4_bnd["bound_ms"],
                                bound_by=b4_bnd["bound_by"],
                                max_abs_err=float((tc_k - tc_p).abs().max()),
                                tape="complete ELP2000 (series rows)")


def series_routes(dev, smi):
    """Phase 24 (c): planet 9 at ``SER_ROUTE_THRESH`` through the series
    route and the expanded tape on the same lanes."""
    t0 = series_times(SER_ROUTE_B, 2)
    out, states, paths = {}, {}, {}
    for name, series_op, kern in (("series", True, ("phase", "series_lin")),
                                  ("expanded", False, ("phase",))):
        sys_ = p9_sys(ht, SER_ROUTE_THRESH, series_op)
        ta = ht.taylor_adaptive_batch(sys_, np.zeros((SER_ROUTE_B, 2)),
                                      time=t0, tol=TOL, device=dev)
        torch.cuda.synchronize()
        zero_launches()
        w0 = time.perf_counter()
        res = ta.propagate_for(SER_ROUTE_T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        launches = dict(jk.LAUNCHES)
        check(only(launches, *kern), f"planet 9 {name}: kernels {launches}")
        check(all(o == ht.TaylorOutcome.time_limit for o in res[0]),
              f"planet 9 {name}: a lane did not end with time_limit")
        states[name] = ta.state
        steps = int(np.asarray(res[3]).sum())
        out[name] = dict(n_uvars=ta._tape.n_uvars, wall_s=wall,
                         lane_steps_per_s=steps / wall,
                         mean_steps_per_lane=steps / SER_ROUTE_B,
                         launches=launches)
        paths[f"p9_{name}"] = launches
    r = rel_max(states["series"], states["expanded"])
    check(r <= SER_ROUTES_RTOL, f"planet 9: the routes differ by {r}")
    return dict(B=SER_ROUTE_B, t_span=SER_ROUTE_T, thresh=SER_ROUTE_THRESH,
                routes_max_rel=r, nvidia_smi=smi, **out), paths


def series_cfuncs(dev, smi):
    """Phase 24 (d): the complete ELP2000 cfunc at ``SER_CF_N`` times (S1's
    launches a call), the published vectors and Pluto's elements on the
    card."""
    names = series_ops(elp_sys(ht, 0.0))
    fns = ht.models.elp2000_cartesian_e2000(thresh=0.0, series_op=True)
    sers = [PS.trig_series(ht.time, *PS.tables(nm)) for nm in names]
    times = series_times(SER_CF_N, 4)
    td = torch.as_tensor(times, device=dev)
    none = torch.zeros((SER_CF_N, 0), dtype=torch.float64, device=dev)
    cf = ht.make_cfunc(fns, vars=[], device=dev)
    cfs = ht.make_cfunc(sers, vars=[], device=dev)
    # S1's launches a call: each entry once a series op with terms of its
    # class at order 0
    zero_launches()
    out = cf(none, time=td)
    torch.cuda.synchronize()
    launches = dict(jk.LAUNCHES)
    gen_ops = sum(bool(sj.split_of(sj.tables_on(nm, dev), 0).gen.size)
                  for nm in names)
    check(only(launches, "series_lin", "series_gen")
          and launches["series_lin"] == len(names)
          and launches["series_gen"] == gen_ops,
          f"ELP2000 cfunc: launches {launches}")
    outs = cfs(none, time=td)
    check(tuple(out.shape) == (SER_CF_N, 3) and bool(
        torch.isfinite(out).all()), "ELP2000 cfunc: bad output")
    m = SER_CF_REF
    want = ht.make_cfunc(fns, vars=[], device="cpu")(np.zeros((m, 0)),
                                                     time=times[:m])
    pos_rel = rel_max(out[:m].cpu(), want)
    check(pos_rel <= SER_CF_POS_RTOL, f"ELP2000 cfunc vs CPU: {pos_rel}")
    worst = 0.0
    u = torch.as_tensor(times[:m])
    for i, nm in enumerate(names):
        tab = sj.tables_on(nm, "cpu")
        val, scale = sj.series_jet_plain(tab, u, torch.zeros_like(u), 0,
                                         with_scale=True)
        worst = max(worst, float(((outs[:m, i].cpu() - val[0]).abs()
                                  / scale[0]).max()))
    check(worst <= SER_RTOL, f"ELP2000 series on the card vs CPU: {worst}")
    ms = [cuda_ms(lambda: cf(none, time=td), 3) for _ in range(2)]
    vec = ht.make_cfunc(ht.models.elp2000_cartesian_e2000(
        thresh=1e-5, series_op=True), vars=[], device=dev)
    tv = torch.as_tensor((ELP_VECTORS[:, 3] - 2451545.0) / 36525.0,
                         device=dev)
    got = vec(torch.zeros((5, 0), dtype=torch.float64, device=dev),
              time=tv).cpu().numpy()
    vec_err = float(np.abs(got - ELP_VECTORS[:, :3]).max())
    check(vec_err <= ELP_VEC_ATOL, f"ELP2000 vectors: {vec_err} km")
    qp = ht.make_cfunc([ht.models.vsop2013_elliptic(
        9, v, thresh=1e-7, series_op=True) for v in (5, 6)], vars=[],
        device=dev)(torch.zeros(0, dtype=torch.float64, device=dev),
                    time=0.0).cpu().numpy()
    incl = 2 * np.degrees(np.arcsin(np.hypot(qp[0], qp[1])))
    node = np.degrees(np.arctan2(qp[1], qp[0])) % 360
    check(abs(incl - 17.15) <= 0.05 and abs(node - 110.29) <= 0.05,
          f"Pluto: inclination {incl}, node {node}")
    return dict(n=SER_CF_N, n_ops=len(cf.dc.ops), ms_runs=ms,
                launches=launches, evals_per_s=SER_CF_N / (min(ms) / 1e3),
                position_max_rel=pos_rel, series_max_err_of_scale=worst,
                ref_points=m, vectors_max_err_km=vec_err,
                pluto_inclination_deg=float(incl),
                pluto_node_deg=float(node), nvidia_smi=smi)


def series_paths(dev, smi, order):
    """Phase 24: the series slice on the card.  Returns the rows of S1's
    two entries for the kernels line (``{entry: (largest error, row)}``),
    B4's time on the ELP2000 tape and the launches on each of the phase's
    paths."""
    s1_rows, line_a = s1_parity(dev, order)
    say("24a", nvidia_smi=smi, **line_a)
    line_b, launches, b4 = elp_complete(dev, smi, order)
    say("24b", **line_b)
    for _, row in s1_rows.values():
        row["profile_share_of_busy"] = line_b["profile"][
            "kernel_share_of_busy"]
    paths = {"elp2000_complete": launches}
    line_c, p_c = series_routes(dev, smi)
    paths.update(p_c)
    say("24c", **line_c)
    line_d = series_cfuncs(dev, smi)
    say("24d", **line_d)
    paths["elp2000_cfunc"] = line_d["launches"]
    return s1_rows, b4, paths


# -- phase 25: the Earth-orientation slice -------------------------------------

EO_B = C5_B  # the full model's lanes
EO_B_DAY = C5_B_SMALL  # its lanes over a day, beside phase 23 (c)
EO_T = C5_REF_T  # about one orbit
EO_DAY = C5_T
EO_REF_T = 600.0  # the CPU reference's span
EO_REF_LANES = 2
EO_WARM_T = 60.0
EO_PROFILE_T = EO_T / 10
EOP_N = 2 ** 20
EOP_RTOL = 1e-15
DAYFRAC_ATOL = 1e-12  # days
PMX_RTOL = 1e-7  # tests/test_eop_sw.py:119-141
EARTH_MU = 3986004.415e8 / 1e9  # km^3/s^2, EGM2008's


def eop_ops(dev, smi):
    """Phase 25 (a): every quantity of the builtin EOP and SW tables
    (value and slope) and ``dayfrac`` at ``EOP_N`` epochs on the card
    against the CPU."""
    dayfrac_mod = importlib.import_module("heyoka_tpu_torch.models.dayfrac")
    rng = np.random.default_rng(0)
    out, worst, n_nan = {}, 0.0, 0
    calls = []
    for data in (ht.EOPData(), ht.SWData()):
        arrs = PE._prepare(data)
        lo, hi = arrs["date"][0], arrs["date"][-1]
        pad = 0.01 * (hi - lo)
        u = rng.uniform(lo - pad, hi + pad, EOP_N)
        ug = torch.as_tensor(u, device=dev)
        for qty in (q for q in arrs if q != "date"):
            name = PE._op_name(data.data_key, qty, False)
            vg, sg = PE.interp0(name, ug)
            vc, sc = PE.interp0(name, torch.as_tensor(u))
            ang = arrs[qty]["angular"]
            errs = []
            for g, c, a in ((vg, vc, ang), (sg, sc, False)):
                g = g.cpu()
                nan = torch.isnan(c)
                check(torch.equal(torch.isnan(g), nan),
                      f"phase 25 (a) {qty}: NaN in other places")
                d = (g - c).abs()[~nan]
                lim = EOP_RTOL if a else EOP_RTOL * c.abs()[~nan]
                check(bool((d <= lim).all()),
                      f"phase 25 (a) {qty}: {float((d / lim).max())}")
                errs.append(float((d / (1.0 if a else c.abs()[~nan]
                                        .clamp_min(1e-300))).max()))
                n_nan += int(nan.sum())
            worst = max(worst, *errs)
            out[qty] = dict(value_err=errs[0], slope_err=errs[1],
                            angular=ang)
            calls.append(lambda n=name, x=ug: PE.interp0(n, x))
    days = rng.uniform(-9700, 10400, EOP_N)  # 1973-2028 in TT days
    dg = dayfrac_mod.ev_dayfrac(torch.as_tensor(days, device=dev)).cpu()
    dc = dayfrac_mod.ev_dayfrac(torch.as_tensor(days))
    dfe = float((dg - dc).abs().max())
    check(dfe <= DAYFRAC_ATOL, f"phase 25 (a) dayfrac: {dfe} days")
    dd = torch.as_tensor(days, device=dev)
    calls.append(lambda: dayfrac_mod.ev_dayfrac(dd))

    def every():
        for c in calls:
            c()
    ms = cuda_ms(every, 3)
    # an interpolant's call gives its value and its slope
    return dict(n=EOP_N, quantities=out, max_err=worst, nan_values=n_nan,
                dayfrac_max_abs_days=dfe, ms_all=ms, calls=len(calls),
                epochs_per_s=len(calls) * EOP_N / (ms / 1e3),
                nvidia_smi=smi)


def kepler_energy(st):
    """The Keplerian specific energy ``0.5 |v|^2 - mu / |r|`` per lane."""
    st = np.asarray(st)
    return 0.5 * (st[:, 3:] ** 2).sum(1) - EARTH_MU / np.linalg.norm(
        st[:, :3], axis=1)


def eo_full(dev, smi, order):
    """Phase 25 (b): the full ``eo_dynamics`` at degree 10 with drag on
    ``EO_B`` lanes over ``EO_T`` and ``EO_B_DAY`` of them over a day (and
    their ``Cb = 0`` twins), B4 against its twin on the tape and its
    times, the profile."""
    torch.cuda.empty_cache()
    w0 = time.perf_counter()
    sys_ = eo_sys(ht, 10, True)
    build_s = time.perf_counter() - w0
    st, pars, t0 = eo_lanes(ht, EO_B)
    epoch = eo_epoch(ht)
    kw = dict(tol=TOL, high_accuracy=True)
    w0 = time.perf_counter()
    ta = ht.taylor_adaptive_batch(sys_, st, pars=pars, time=t0, device=dev,
                                  **kw)
    construct_s = time.perf_counter() - w0
    ta.assert_engine(jet="hy_phase_f64", propagate_engine="flat")
    tape = ta._jtape
    W, K = tape.width, tape.order
    buf = 8 * (K + 1) * W * EO_B
    free, total = torch.cuda.mem_get_info(dev)
    check(2 * buf < free, f"phase 25 (b): B4's buffer {buf} B, {free} free")

    def lanes(n, zero_cb=False):
        return ht.TaylorAdaptiveBatch._sharing(
            ta, st[:n], pars=0.0 * pars[:n] if zero_cb else pars[:n],
            time=t0[:n])

    lanes(64).propagate_until(epoch + EO_WARM_T)
    torch.cuda.synchronize()
    zero_launches()
    w0 = time.perf_counter()
    first = ta.propagate_until(epoch + EO_REF_T)[3]
    st_ref = ta.state[:EO_REF_LANES]
    oc, _, _, nsteps = ta.propagate_until(epoch + EO_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    launches = dict(jk.LAUNCHES)
    check(only(launches, "phase"), f"phase 25 (b): kernels {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in oc)
          and bool((ta.time == epoch + EO_T).all()),
          "phase 25 (b): a lane did not land with time_limit")
    check(bool(np.isfinite(ta.state).all()), "phase 25 (b): bad state")
    steps = int(first.sum() + nsteps.sum())
    ref = ht.TaylorAdaptiveBatch._sharing(
        ta, st[:EO_REF_LANES], pars=pars[:EO_REF_LANES],
        time=t0[:EO_REF_LANES], device="cpu")
    ref.propagate_until(epoch + EO_REF_T)
    ref_rel = rel_max(st_ref, ref.state)
    check(ref_rel <= REF_RTOL, f"phase 25 (b) vs the CPU run: {ref_rel}")
    prof = profiled(lambda: lanes(EO_B), epoch + EO_PROFILE_T,
                    "phase_kernel")
    # B4 launches once a step: the other device kernels of the window
    # are the driver's and order 0's
    prof["other_kernels_a_step"] = (
        (prof["device_events"] - prof["kernel_events"])
        / max(prof["kernel_events"], 1))
    del ref

    # 1,024 lanes over a day, and their Cb = 0 twins
    zero_launches()
    day, dres, dwall = timed_call(lambda: lanes(EO_B_DAY),
                                  lambda t: t.propagate_until(epoch + EO_DAY))
    day_launches = dict(jk.LAUNCHES)
    check(only(day_launches, "phase"), f"phase 25 (b) day: {day_launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in dres[0]),
          "phase 25 (b) day: a lane did not end with time_limit")
    free_run = lanes(EO_B_DAY, zero_cb=True)
    free_run.propagate_until(epoch + EO_DAY)
    de = kepler_energy(day.state) - kepler_energy(free_run.state)
    check(bool(np.isfinite(de).all() and (de < 0).all()),
          f"phase 25 (b): a lane's energy is not below its Cb = 0 twin's "
          f"(max difference {float(np.max(de))})")
    day_steps = int(np.asarray(dres[3]).sum())
    del day, free_run

    # B4 against its twin on the tape at 1,024 lanes, its times
    tc0 = seeded_buffer(tape, st[:EO_B_DAY], pars[:EO_B_DAY],
                        t0[:EO_B_DAY], dev)
    side = jp.order0(tape, tc0)
    tck = jp.phase(tape, tc0.clone(), 1, side)
    tcp = jp.phase_plain(tape, tc0.clone(), 1, side)
    rel = float(per_order_rel(tck.permute(1, 0, 2),
                              tcp.permute(1, 0, 2)).max())
    nk, npl = jk._norms(tape, tck), jk._norms(tape, tcp)
    nrel = float(((nk - npl).abs().amax(1) / npl.abs().amax(1)).max())
    check(rel <= C5_JET_RTOL and nrel <= C5_JET_RTOL,
          f"B4 vs phase_plain on eo_dynamics: {rel}, norms {nrel}")
    err = float((tck - tcp).abs().max())
    a, b = tc0.clone(), tc0.clone()
    t = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        t[which].append(graph_ms(lambda: jp.phase(tape, a, 1, side), 5)
                        if which == "kernel" else
                        cuda_ms(lambda: jp.phase_plain(tape, b, 1, side), 1))

    def bound(n):
        return rl.bound(rl.phase_flops(tape.arrays, 1) * n,
                        rl.phase_bytes(tape.arrays, n, 1, 8)
                        + rl.nbytes(tape.itab, tape.dtab), torch.float64)
    bnd = bound(EO_B_DAY)
    kern = dict(timed(t["kernel"], t["plain"], bnd), ms_runs=t["kernel"],
                plain_ms_runs=t["plain"], max_rel_per_order=rel,
                norms_max_rel=nrel, max_abs_err=err, lanes=EO_B_DAY,
                shape=jp.layout_report(tape, EO_B_DAY))
    del tc0, tck, tcp, a, b
    big = seeded_buffer(tape, st, pars, t0, dev)
    bside = jp.order0(tape, big)
    bnd_big = bound(EO_B)
    big_ms = graph_ms(lambda: jp.phase(tape, big, 1, bside), 2)
    kern["b10240"] = dict(ms=big_ms, bound_ms=bnd_big["bound_ms"],
                          bound_by=bnd_big["bound_by"],
                          x_bound=big_ms / bnd_big["bound_ms"],
                          shape=jp.layout_report(tape, EO_B))
    del big, bside
    line = dict(
        B=EO_B, t_span=EO_T, order=K, W=W,
        n_ops=int(tape.arrays["arg_ptr"].size - 1),
        levels=int(tape.lvl.size - 1), groups=len(tape.pgroups),
        n_slope_rows=tape.n_slope, buffer_bytes=buf, free_bytes=free,
        build_s=build_s, construct_s=construct_s, wall_s=wall,
        lane_steps=steps, mean_steps_per_lane=steps / EO_B,
        lane_steps_per_s=steps / wall, launches=launches,
        cpu_ref=dict(lanes=EO_REF_LANES, t=EO_REF_T, max_rel=ref_rel),
        day=dict(B=EO_B_DAY, t_span=EO_DAY, wall_s=dwall,
                 lane_steps=day_steps, lane_steps_per_s=day_steps / dwall,
                 mean_steps_per_lane=day_steps / EO_B_DAY,
                 energy_below_cb0=dict(min=float(de.min()),
                                       max=float(de.max())),
                 config5_drag_lane_steps_per_s=RATES.get("config5_drag")),
        b4=kern, bound=bnd, profile=prof, nvidia_smi=smi)
    kern_row = dict(ms=kern["ms"], plain_ms=kern["plain_ms"],
                    bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"],
                    max_abs_err=err, lanes=EO_B_DAY,
                    ms_b10240=big_ms, bound_ms_b10240=bnd_big["bound_ms"],
                    tape="eo_dynamics degree 10 + thermoNET drag")
    return line, {"eo_dynamics_b10240": launches,
                  "eo_dynamics_day_b1024": day_launches}, kern_row


def pm_x_ode(dev, smi):
    """Phase 25 (c): ``tests/test_eop_sw.py``'s ``pm_x`` ODE (two days
    from 2020-01-01, steps capped at 0.02 days) on the card, against the
    trapezoid integral of the interpolant."""
    x = ht.make_vars("x")
    t1, t2 = ht.utils.jd_utc_to_tt(ht.utils.cal_to_jd(2020, 1, 1), 0.0)
    t0 = float(((t1 - 2451545.0) + t2) / 36525.0)
    ta = ht.taylor_adaptive([(x, ht.models.pm_x() * 1e6)], [0.0], time=t0,
                            tol=1e-12, device=dev)
    zero_launches()
    ta.propagate_until(t0 + 2.0 / 36525.0, max_delta_t=0.02 / 36525.0)
    launches = dict(jk.LAUNCHES)
    check(only(launches, "phase"), f"phase 25 (c): kernels {launches}")
    eop = ht.EOPData()
    mjd0 = ht.utils.cal_to_jd(2020, 1, 1) - 2400000.5
    i = int(np.searchsorted(eop.table[:, 0], mjd0))
    dates = PE._date_tt_cy(eop.table[i:i + 3, 0])
    vals = eop.table[i:i + 3, 2] * (np.pi / (180.0 * 3600.0)) * 1e6
    want = float(np.sum(0.5 * (vals[1:] + vals[:-1]) * np.diff(dates)))
    got = float(ta.state[0])
    rel = abs(got - want) / abs(want)
    check(rel <= PMX_RTOL, f"phase 25 (c): {got} vs {want}")
    return dict(got=got, want=want, rel=rel, tol=PMX_RTOL,
                launches=launches, nvidia_smi=smi)


def eo_paths(dev, smi, order):
    """Phase 25: the Earth-orientation slice on the card.  Returns B4's
    row additions (its error and times on the eo_dynamics tape) and the
    launches on each of the phase's paths."""
    say("25a", **eop_ops(dev, smi))
    line_b, paths, b4 = eo_full(dev, smi, order)
    say("25b", **line_b)
    line_c = pm_x_ode(dev, smi)
    paths["pm_x_ode"] = line_c["launches"]
    say("25c", **line_c)
    return b4, paths


# -- phase 26: float32 (ROADMAP C.4) ------------------------------------------

F32_TOL = 1e-6  # test_float32_mode's tolerance: order 8
#: B4-f32 against its f32 twin: every order within this share of its
#: largest magnitude (T2's bar, PERF.md section 2)
F32_RTOL = 1e-5
F32_LO = 5  # (a)'s second start on the every-opcode tapes
#: test_float32_mode's horizon and bar: f32 against f64 at the same tol
F32_MODE_T, F32_MODE_BAR = 10.0, 5e-4
#: the f32 pendulum against f64 at t = 100: f32's own error grows with the
#: ~1,250 steps (7.3e-4 on 256 of the lanes on the CPU, measured), so
#: ten times that; the CPU's f32 runs of 16 and of 256 lanes part by
#: 1.8e-5 at t = 10 and 6.4e-4 at t = 100 (torch's f32 sin/cos take other
#: code paths by width), hence the bars against the CPU run
F32_T100_BAR = 5e-3
F32_CPU_T10, F32_CPU_T100 = 1e-4, 5e-3
F32_DRIFT_MAX = 1e-4  # the relative energy drift at t = 100 (5.2e-6 CPU)
F32_REF_LANES = 16
F32_CF_N = 2 ** 20
F32_CF_RTOL = 1e-5  # f32 rounding, relative to the largest value
F32_SGP4_KM = 2.0  # SGP4 in f32 against f64: f32's rounding over a day
F32_SGP4_RTOL = 1e-5  # against the CPU's f32 run, relative


def f32_parity(dev, order):
    """Phase 26 (a): B4-f32 against its f32 twin on the card: every tape
    of ``cases.phase_cases`` at order 8 on 1,024 lanes from lo = 1 and
    lo = 5, the pendulum on phase 11's 10,240 lanes, the outer SS on
    10,240 lanes at the f32 order and at order 19 from lo = 9 (T2's
    buffer); two runs bit for bit, every forced block shape on the
    pendulum, and B4-f32 against B4-f64 on the same inputs.  Returns the
    line, the largest abs error, and the pendulum's times."""
    K = taylor_order_from_tol(F32_TOL)
    f32 = torch.float32

    def rel(a, b):
        return per_order_rel(a.permute(1, 0, 2).double(),
                             b.permute(1, 0, 2).double())

    def tape_of(sys_, k):
        plan = build_plan(ht.taylor_decompose_sys(sys_), k)
        return jp.PhaseTape(ht.plan_to_arrays(plan), dev)

    res, err, ops = {}, 0.0, set()

    def hold(name, tape, tc0, lo):
        nonlocal err
        tc_k = jp.phase(tape, tc0.clone(), lo)
        twice = jp.phase(tape, tc0.clone(), lo)
        tc_p = jp.phase_plain(tape, tc0.clone(), lo)
        tc64 = jp.phase(tape, tc0.double(), lo)
        torch.cuda.synchronize()
        check(tc_k.dtype == f32 and bool(torch.isfinite(tc_k).all()),
              f"B4-f32 on {name}: dtype or non-finite")
        check(torch.equal(tc_k, twice), f"B4-f32 on {name}: two runs differ")
        r = float(rel(tc_k, tc_p).max())
        check(r <= F32_RTOL, f"B4-f32 vs its twin on {name} from {lo}: {r}")
        err = max(err, float((tc_k - tc_p).abs().max()))
        return dict(max_rel_per_order=r,
                    vs_f64_rel_per_order=rel(tc_k, tc64).tolist())

    cases = phase_cases(ht)
    for i, (name, (sys_, st0, pars)) in enumerate(cases.items()):
        tape = tape_of(sys_, K)
        ops |= {g[0] for g in tape.groups}
        tc0 = seeded_buffer(tape, *phase_lanes(st0, pars, PHASE_B, 20 + i),
                            dev, f32)
        n_w = int(tape.lvl[-1])
        r1 = hold(name, tape, tc0, 1)
        tc5 = jp.phase_plain(tape, tc0.clone(), 1)
        tc5[F32_LO:, :n_w] = float("nan")
        r5 = float(rel(jp.phase(tape, tc5, F32_LO),
                       jp.phase_plain(tape, tc0.clone(), 1)).max())
        check(r5 <= F32_RTOL, f"B4-f32 on {name} from lo = {F32_LO}: {r5}")
        res[name] = dict(r1, lo5_max_rel_per_order=r5,
                         shape=jp.layout_report(tape, PHASE_B, 4))
    missing = sorted(set(ht.PHASE_OPS) - ops - {
        "trigseries", "interp", "interp_p", "dayfrac"})
    check(not missing, f"phase 26 (a) ran no tape with {missing}")
    # the pendulum at phase 11's width, every forced shape bit for bit
    pend = tape_of(ht.models.pendulum(), K)
    pl = (pendulum_lanes(PEND_B, 0), np.zeros((PEND_B, 0)), np.zeros(PEND_B))
    tc0 = seeded_buffer(pend, *pl, dev, f32)
    res["pendulum_10240"] = hold("the pendulum", pend, tc0, 1)
    ref = jp.phase(pend, tc0.clone(), 1)
    shapes = jp.sweep_shapes(pend, 4)
    for lay, L, nt in shapes:
        check(torch.equal(jp._phase_cuda(pend, tc0.clone(), 1, L, nt, lay),
                          ref), f"B4-f32 on the pendulum with {L} lanes x "
              f"{nt} threads on {lay} differs from the default")
    res["pendulum_10240"].update(shapes_equal=len(shapes),
                                 shape=jp.layout_report(pend, PEND_B, 4))
    # the outer SS at the f32 order from lo = 1
    ss_sys = nbody(6, masses=MASSES, Gconst=GCONST)
    ss = tape_of(ss_sys, taylor_order_from_tol(np.finfo(np.float32).eps))
    ss_lanes = (lanes(IC, B_MAIN, 0), np.zeros((B_MAIN, 0)), np.zeros(B_MAIN))
    res["outer_ss"] = dict(hold("the outer SS", ss, seeded_buffer(
        ss, *ss_lanes, dev, f32), 1), K=ss.order,
        shape=jp.layout_report(ss, B_MAIN, 4))
    # and at order 19 from lo = 9 on T2's buffer (phase 14), for B.7
    ss_plan = proto_phase.outer_ss_plan(order)
    ss19 = jp.PhaseTape(ht.plan_to_arrays(ss_plan), dev)
    tc19 = proto_phase.realistic_buffer(ss_plan, IC, B_MAIN, PHASE_LO, dev,
                                        0).permute(1, 0, 2).contiguous()
    res["outer_ss_o19_lo9"] = hold("the outer SS at order 19", ss19, tc19,
                                   PHASE_LO)
    # times, f64 and f32 in turns (CUDA graphs), the f32 twin beside
    times = {}
    for key, tape, tc, lo in (("pendulum", pend, tc0, 1),
                              ("outer_ss_o19_lo9", ss19, tc19, PHASE_LO)):
        b32, b64, bp = tc.clone(), tc.double(), tc.clone()
        t = {"f64": [], "f32": []}
        for which in ("f64", "f32", "f32", "f64"):
            buf = b32 if which == "f32" else b64
            t[which].append(graph_ms(lambda: jp.phase(tape, buf, lo), 10))
        plain = [cuda_ms(lambda: jp.phase_plain(tape, bp, lo), 1)
                 for _ in range(2)]
        ms32, ms64 = sum(t["f32"]) / 2, sum(t["f64"]) / 2
        bnd = rl.phase_bound(tape, tc.shape[-1], lo, f32)
        times[key] = dict(
            B=tc.shape[-1], K=tape.order, lo=lo, ms_runs=t["f32"],
            f64_ms_runs=t["f64"], ratio_f32_to_f64=ms32 / ms64,
            plain_ms_runs=plain, x_bound=ms32 / bnd["bound_ms"],
            f64_bound=rl.phase_bound(tape, tc.shape[-1], lo,
                                     torch.float64), **bnd)
    line = dict(K=K, B=PHASE_B, tol=F32_RTOL, opcodes=sorted(
        ops, key=ht.OPCODES.index), max_abs_err=err, tapes=res, times=times)
    return line, err, times["pendulum"]


def f32_pendulum(dev, smi, f64_until):
    """Phase 26 (b): the pendulum in f32 at 10,240 lanes (phase 11's) at
    tol 1e-6 to t = 100 on kernel B4-f32, held to the f64 run of the same
    lanes at the same tolerance and to the port's f32 CPU run; the scalar
    likewise.  Returns the line and the launches on the path."""
    from torch.profiler import ProfilerActivity, profile
    sys_ = ht.models.pendulum()
    ics = pendulum_lanes(PEND_B, 0)
    kw32 = dict(tol=F32_TOL, dtype=np.float32)
    warm = ht.taylor_adaptive_batch(sys_, ics[:CHUNK], device=dev, **kw32)
    warm.propagate_until(1.0)
    # the f64 run at the same tolerance (order 8), then the f32 run
    r64, st64 = {}, {}
    t64 = ht.taylor_adaptive_batch(sys_, ics, device=dev, tol=F32_TOL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t_end in (F32_MODE_T, PEND_T):
        r64[t_end] = t64.propagate_until(t_end)
        st64[t_end] = t64.state
    torch.cuda.synchronize()
    wall64 = time.perf_counter() - t0
    steps64 = int(sum(int(r[3].sum()) for r in r64.values()))
    ta = ht.taylor_adaptive_batch(sys_, ics, device=dev, **kw32)
    eng = ta.engine_report()
    check(eng["jet"] == "hy_phase_f32" and eng["propagate_engine"] == "flat",
          f"f32 pendulum: not B4-f32's route: {eng}")
    res, st32 = {}, {}
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    for t_end in (F32_MODE_T, PEND_T):
        res[t_end] = ta.propagate_until(t_end)
        st32[t_end] = ta.state
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(jk.LAUNCHES)
    check(launches["phase_f32"] > 0 and all(
        n == 0 for k, n in launches.items() if k != "phase_f32"),
        f"f32 pendulum: kernels launched {launches}")
    check(ta._state.dtype == ta._tc.dtype == ta._t_hi.dtype
          == ta._last_h.dtype == torch.float32, "f32 pendulum: not f32")
    for t_end, r in res.items():
        check(all(o == ht.TaylorOutcome.time_limit for o in r[0]),
              f"f32 pendulum: an outcome at {t_end} is not time_limit")
    check(bool((ta.dtime[0] == PEND_T).all()),
          "f32 pendulum: a lane did not land on t = 100")
    check(bool(np.isfinite(st32[PEND_T]).all()), "f32 pendulum: non-finite")
    d10 = float(np.abs(st32[F32_MODE_T] - st64[F32_MODE_T]).max())
    d100 = float(np.abs(st32[PEND_T] - st64[PEND_T]).max())
    check(d10 <= F32_MODE_BAR, f"f32 vs f64 at t = 10: {d10}")
    check(d100 <= F32_T100_BAR, f"f32 vs f64 at t = 100: {d100}")
    e0 = pendulum_energy(torch.as_tensor(ics, device=dev))
    e1 = pendulum_energy(torch.as_tensor(st32[PEND_T], device=dev).double())
    drift = float(((e1 - e0).abs() / e0.abs()).max())
    check(drift <= F32_DRIFT_MAX, f"f32 pendulum: energy drift {drift}")
    cpu = ht.taylor_adaptive_batch(sys_, ics[:F32_REF_LANES], device="cpu",
                                   **kw32)
    cpu_d = {}
    for t_end in (F32_MODE_T, PEND_T):
        cpu.propagate_until(t_end)
        cpu_d[t_end] = float(np.abs(
            st32[t_end][:F32_REF_LANES] - cpu.state).max())
    check(cpu_d[F32_MODE_T] <= F32_CPU_T10 and cpu_d[PEND_T] <= F32_CPU_T100,
          f"f32 pendulum vs the CPU run: {cpu_d}")
    steps = int(sum(int(r[3].sum()) for r in res.values()))
    # the first 10 time units under the profiler: the idle share
    tp = ht.taylor_adaptive_batch(sys_, ics, device=dev, **kw32)
    tw = ht.taylor_adaptive_batch(sys_, ics, device=dev, **kw32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tw.propagate_until(PROFILE_T)
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tp.propagate_until(PROFILE_T)
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e6
    b4 = sum(e.time_range.elapsed_us() for e in ev
             if "phase_kernel" in e.name) / 1e6
    # the scalar on the card, against its CPU run and its f64 run
    sc, sc_d = {}, {}
    for name, d, kw in (("f32", dev, kw32), ("f64", dev, dict(tol=F32_TOL)),
                        ("cpu_f32", "cpu", kw32)):
        s = ht.taylor_adaptive(sys_, [0.05, 0.025], device=d, **kw)
        if name == "f32":
            check(s.engine_report()["jet"] == "hy_phase_f32",
                  "f32 scalar: not B4-f32")
            zero_launches()
        for t_end in (F32_MODE_T, PEND_T):
            oc = s.propagate_until(t_end)[0]
            check(oc == ht.TaylorOutcome.time_limit and s.time == t_end,
                  f"{name} scalar: {oc} at {s.time}")
            sc[(name, t_end)] = s.state
        if name == "f32":
            sc_launch = dict(jk.LAUNCHES)
            check(sc_launch["phase_f32"] > 0 and all(
                n == 0 for k, n in sc_launch.items() if k != "phase_f32"),
                f"f32 scalar: kernels launched {sc_launch}")
            check(s.state.dtype == np.float32, "f32 scalar: not f32")
    for t_end, bar64, barc in ((F32_MODE_T, F32_MODE_BAR, F32_CPU_T10),
                               (PEND_T, F32_T100_BAR, F32_CPU_T100)):
        sc_d[t_end] = dict(
            vs_f64=float(np.abs(sc[("f32", t_end)]
                                - sc[("f64", t_end)]).max()),
            vs_cpu=float(np.abs(sc[("f32", t_end)]
                                - sc[("cpu_f32", t_end)]).max()))
        check(sc_d[t_end]["vs_f64"] <= bar64
              and sc_d[t_end]["vs_cpu"] <= barc,
              f"f32 scalar at {t_end}: {sc_d[t_end]}")
    line = dict(
        B=PEND_B, tol=F32_TOL, order=ta.order, t_end=PEND_T, engine=eng,
        launches=launches, wall_s=wall, lane_steps=steps,
        steps_per_s=steps / wall, mean_steps_per_lane=steps / PEND_B,
        f64_same_tol=dict(wall_s=wall64, lane_steps=steps64,
                          steps_per_s=steps64 / wall64),
        f64_phase11=f64_until, rate_vs_f64_same_tol=(steps / wall)
        / (steps64 / wall64), rate_vs_phase11=(steps / wall)
        / f64_until["steps_per_s"],
        vs_f64_max_abs={"t10": d10, "t100": d100},
        bars={"t10": F32_MODE_BAR, "t100": F32_T100_BAR,
              "cpu_t10": F32_CPU_T10, "cpu_t100": F32_CPU_T100},
        cpu_ref_lanes=F32_REF_LANES,
        cpu_ref_max_abs={"t10": cpu_d[F32_MODE_T], "t100": cpu_d[PEND_T]},
        energy_drift_max_rel=drift, profile_t_end=PROFILE_T,
        profile_wall_s=wall_w, device_events=len(ev),
        device_busy_s=busy if ev else None,
        device_idle_share=1.0 - busy / wall_w if ev else None,
        b4_share_of_busy=b4 / busy if ev else None,
        scalar=dict(launches=sc_launch, **{
            f"t{int(t)}": v for t, v in sc_d.items()}), nvidia_smi=smi)
    return line, dict(f32_pendulum=launches, f32_scalar=sc_launch)


def f32_evals(dev, smi):
    """Phase 26 (c): the f32 cfunc at 2^20 points and SGP4 in f32 on
    16,384 satellites at 32 epochs (phase 23 (d)'s), each against the
    CPU's f32 run and the card's f64 run, with their rates."""
    from heyoka_tpu_torch.utils import cal_to_jd
    rng = np.random.default_rng(26)
    x, y = ht.make_vars("x", "y")
    t = ht.time
    cases = {
        "jacobi": ([ht.models.cr3bp_jacobi(mu=VAR_MU)],
                   ["x", "y", "z", "px", "py", "pz"],
                   rng.uniform(-1.0, 1.0, (F32_CF_N, 6)), {}),
        "inertial_time": ([x * ht.cos(t) - y * ht.sin(t),
                           x * ht.sin(t) + y * ht.cos(t)], ["x", "y"],
                          rng.uniform(-1.0, 1.0, (F32_CF_N, 2)),
                          {"time": rng.uniform(0.0, 100.0, F32_CF_N)}),
    }
    out = {}
    for name, (fns, vars_, pts, kw) in cases.items():
        r = {}
        for dt in (np.float32, np.float64):
            cf = ht.make_cfunc(fns, vars=vars_, device=dev, dtype=dt)
            args = {k: torch.as_tensor(v.astype(dt), device=dev)
                    for k, v in kw.items()}
            pts_d = torch.as_tensor(pts.astype(dt), device=dev)
            r[dt] = cf(pts_d, **args)
            ms = [cuda_ms(lambda: cf(pts_d, **args), 3) for _ in range(2)]
            r[(dt, "rate")] = F32_CF_N / (min(ms) / 1e3)
        cpu = ht.make_cfunc(fns, vars=vars_, device="cpu", dtype=np.float32)
        want = cpu(pts.astype(np.float32), **{
            k: v.astype(np.float32) for k, v in kw.items()})
        got = r[np.float32]
        check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
              f"f32 cfunc {name}: output")
        vs_cpu = rel_max(got.cpu(), want)
        vs_f64 = rel_max(got.double().cpu(), r[np.float64].cpu())
        check(vs_cpu <= F32_CF_RTOL and vs_f64 <= F32_CF_RTOL,
              f"f32 cfunc {name}: {vs_cpu} vs the CPU, {vs_f64} vs f64")
        out[name] = dict(n=F32_CF_N, vs_cpu_f32_rel=vs_cpu,
                         vs_f64_rel=vs_f64,
                         evals_per_s_f32=r[(np.float32, "rate")],
                         evals_per_s_f64=r[(np.float64, "rate")])
    g = sgp4_population(SGP4_N)
    g[7], g[8] = cal_to_jd(2024, 3, 1), 0.25
    tm = np.broadcast_to(np.linspace(0.0, 1440.0, SGP4_EPOCHS)[:, None],
                         (SGP4_EPOCHS, SGP4_N)).copy()
    res, rate = {}, {}
    for dt in (np.float32, np.float64):
        prop = ht.models.SGP4Propagator(g, device=dev, dtype=dt)
        tm_d = torch.as_tensor(tm.astype(dt), device=dev)
        res[dt] = prop(tm_d)
        ms = [cuda_ms(lambda: prop(tm_d), 3) for _ in range(2)]
        rate[dt] = SGP4_N * SGP4_EPOCHS / (min(ms) / 1e3)
    s32, s64 = res[np.float32], res[np.float64]
    check(s32.dtype == torch.float32 and bool(torch.isfinite(s32).all()),
          "f32 sgp4: output")
    km = float((s32[..., :3].double() - s64[..., :3]).abs().amax())
    kms = float((s32[..., 3:6].double() - s64[..., 3:6]).abs().amax())
    check(km <= F32_SGP4_KM, f"f32 sgp4 vs f64: {km} km")
    cpu = ht.models.SGP4Propagator(g[:, :SGP4_REF_SATS].copy(), device="cpu",
                                   dtype=np.float32)
    want = cpu(tm[:, :SGP4_REF_SATS].astype(np.float32))
    vs_cpu = rel_max(s32[:, :SGP4_REF_SATS, :6].cpu(), want[..., :6])
    check(vs_cpu <= F32_SGP4_RTOL, f"f32 sgp4 vs the CPU: {vs_cpu}")
    out["sgp4"] = dict(sats=SGP4_N, epochs=SGP4_EPOCHS,
                       vs_f64_max_km=km, vs_f64_max_km_s=kms,
                       cpu_ref_sats=SGP4_REF_SATS, vs_cpu_f32_rel=vs_cpu,
                       sat_epochs_per_s_f32=rate[np.float32],
                       sat_epochs_per_s_f64=rate[np.float64])
    out["nvidia_smi"] = smi
    return out


#: phase 26 (d)'s child process: from a process that has loaded no
#: library, pack the checkout's built library (``s11n.pack_cache``), unpack
#: it into a fresh directory, ``enable_compilation_cache`` there, and launch
#: B4-f32 and B4-f64 with no ``nvcc`` to be found; one JSON line
S11N_CHILD = r"""
import json, shutil, sys
import numpy as np, torch
import heyoka_tpu_torch as ht
from heyoka_tpu_torch import _build, s11n
from heyoka_tpu_torch.taylor import jet_phase as jp
from heyoka_tpu_torch.taylor.compact import build_plan
from chip_smoke import F32_RTOL, pendulum_lanes, per_order_rel, seeded_buffer
dest, archive = sys.argv[1:3]
assert _build.loaded_path() is None and shutil.which("nvcc") is None
built = s11n.cache_entries()
n_packed = s11n.pack_cache(archive)
n_unpacked = s11n.unpack_cache(archive, dest)
s11n.enable_compilation_cache(dest)
dev = torch.device("cuda")
tape = jp.PhaseTape(ht.plan_to_arrays(build_plan(
    ht.taylor_decompose_sys(ht.models.pendulum()), 8)), dev)
B = 1024
rel = {}
for dt in (torch.float32, torch.float64):
    tc0 = seeded_buffer(tape, pendulum_lanes(B, 1), np.zeros((B, 0)),
                        np.zeros(B), dev, dt)
    k = jp.phase(tape, tc0.clone(), 1)
    p = jp.phase_plain(tape, tc0.clone(), 1)
    torch.cuda.synchronize()
    rel[str(dt)] = float(per_order_rel(k.permute(1, 0, 2).double(),
                                       p.permute(1, 0, 2).double()).max())
loaded = _build.loaded_path()
ok = (loaded is not None and str(loaded.parent) == str(
    _build.build_dir()) and loaded.name == _build.library_path().name
      and n_packed == n_unpacked == len(built) >= 1
      and rel["torch.float32"] <= F32_RTOL and rel["torch.float64"] <= 1e-13)
print(json.dumps(dict(ok=ok, packed=n_packed, unpacked=n_unpacked,
                      loaded=loaded.name, loaded_from=s11n.cache_path(),
                      nvcc=shutil.which("nvcc"), max_rel_per_order=rel,
                      cache_size=s11n.cache_size())))
"""


def s11n_cache(dev):
    """Phase 26 (d): the s11n cache on the card, in a child process (so
    that no library is already loaded) whose PATH holds no ``nvcc`` and
    whose ``CUDA_HOME`` names no toolkit: the unpacked library loads and
    B4 matches its twin."""
    import os
    import shutil
    import subprocess
    from pathlib import Path
    root = Path(__file__).resolve().parent
    work = root / "build" / "s11n_phase26"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ, CUDA_HOME=str(work / "no_cuda"),
               PYTHONPATH=str(root))
    env.pop("CUDA_PATH", None)
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))
    try:
        r = subprocess.run(
            [sys.executable, "-c", S11N_CHILD, str(work / "cache"),
             str(work / "kernels.tar.gz")], capture_output=True, text=True,
            cwd=root, env=env, timeout=300)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(r.returncode == 0, f"s11n child failed: {r.stderr[-2000:]}")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    check(line["ok"], f"s11n cache: {line}")
    return line


def f32_paths(dev, smi, order, pend_until):
    """Phase 26: float32 on the card (ROADMAP C.4).  Returns B4-f32's
    kernel row and the launches on each of the phase's paths."""
    line_a, err, tm = f32_parity(dev, order)
    say("26a", nvidia_smi=smi, **line_a)
    line_b, paths = f32_pendulum(dev, smi, pend_until)
    say("26b", **line_b)
    say("26c", **f32_evals(dev, smi))
    say("26d", **s11n_cache(dev))
    row = dict(ms=sum(tm["ms_runs"]) / 2,
               plain_ms=sum(tm["plain_ms_runs"]) / 2, library_ms=None,
               bound_ms=tm["bound_ms"], bound_by=tm["bound_by"],
               x_bound=tm["x_bound"], f64_ms=sum(tm["f64_ms_runs"]) / 2,
               ratio_f32_to_f64=tm["ratio_f32_to_f64"], K=tm["K"],
               B=tm["B"], path_launches={k: v["phase_f32"]
                                         for k, v in paths.items()})
    return paths["f32_pendulum"]["phase_f32"], err, row



# -- phase 27: C.4's remainder in f32 and the native host runtime (A.22) ---

HH27_T = HH_GRID_T  # the f32 HH run's horizon, a tenth of phase 18's
#: f32 against f32 on the CPU and against f64, the HH hit times: the CPU's
#: f32 run of 256 lanes to t = 20 parts from f64 by 1.8e-6 (measured);
#: ten times that
HH27_HIT_ATOL = 2e-5
HH27_DRIFT_MAX = 1e-5  # the f32 energy drift at t = 20 (9.5e-7 on the CPU)
#: config 4 in f32 at B = 2,048 to t = 10: |det STM - 1| was 1.1e-4 on the
#: CPU, the states 6.2e-5 (relative) from f64 and the CPU's 16- and
#: 64-lane f32 runs 1.3e-5 apart: ten times each
VAR27_B = VAR_B[0]
VAR27_DET = 1e-3
VAR27_F64_RTOL = 1e-3
VAR27_CPU_RTOL = 2e-4
#: the ELP2000 ODE's states are < 1e-7 (``x' = 1e-10 c``), so f32's
#: tolerance (1.19e-7, absolute for |x| < 1) exceeds them: at that tol the
#: f64 run parts from tol 1e-15 as much as f32 does (the same 1.5e-8 on
#: the CPU), and f32's time rounds the 1e4-rad/century phases by ~1e-3
#: rad (f32 and f64 at one tol 4.5e-10 apart on the card's 10,240 lanes,
#: 5e-12 on 8 CPU lanes).  The bars: 10 times the f32 tolerance
#: (absolute) against both f64 runs; against the CPU's f32 run of the
#: same lanes 1e-2 of the largest |x|
ELP27_B = SER_B
ELP27_T = SER_T / 10
ELP27_REF_LANES = 4
ELP27_ABS = 10 * float(np.finfo(np.float32).eps)
ELP27_RTOL = 1e-2
#: the pm_x ODE in f32: within the f32 tolerance (absolute) of the f64 run
#: (3.7e-9 on the CPU) and of the CPU's f32 run
PMX27_ABS = float(np.finfo(np.float32).eps)
NATIVE_B = (8, 64, 256)  # propagate_until on the host and on the card

NATIVE_WARM = r"""
import json, sys, threading, time
import heyoka_tpu_torch as ht
from heyoka_tpu_torch import native, native_cg
from heyoka_tpu_torch.tools import GCONST, MASSES
t0 = time.perf_counter()
ok = native.native_available()
rt_s = time.perf_counter() - t0
tape = ht.taylor_decompose_sys(ht.models.nbody(6, masses=MASSES,
                                               Gconst=GCONST))
order = ht.taylor_order_from_tol(1e-15)
out, errs = {}, []

def build(W):
    t = time.perf_counter()
    try:
        native_cg.CompiledTape(tape, order, W=W)
    except Exception as e:
        errs.append(repr(e))
    out[W] = time.perf_counter() - t

th = [threading.Thread(target=build, args=(W,)) for W in (1, 8)]
for t in th:
    t.start()
for t in th:
    t.join()
print(json.dumps(dict(ok=ok and not errs, runtime_s=rt_s, errors=errs,
                      codegen_s={str(k): v for k, v in out.items()},
                      wall_s=time.perf_counter() - t0,
                      build_error=native.build_error())))
"""


def use_path_gxx():
    """Build the native route with the ``g++`` on PATH: set ``CXX`` to it
    (the card's host sets ``CXX`` to a wrapper of its own GCC whose driver
    finds no ``libgomp.spec``, so ``-fopenmp`` fails there, while the
    ``g++`` on PATH links OpenMP).  Returns the compiler, or the ``CXX``
    already set where PATH has no ``g++``."""
    import os
    import shutil
    gxx = shutil.which("g++")
    if gxx is not None:
        os.environ["CXX"] = gxx
    return os.environ.get("CXX", "g++")


def start_native_build():
    """The native runtime and the outer-SS stepper (W = 1 for the scalar,
    8 for the batch) built in a child process at a lower priority while
    the device phases run: ``g++`` takes ~20 s and ~40 s on one core each
    for this tape, and phase 27 (d) then loads them from the build
    directory; the compiler is :func:`use_path_gxx`'s.  Returns the
    child."""
    import os
    import subprocess
    from pathlib import Path
    use_path_gxx()
    root = Path(__file__).resolve().parent
    return subprocess.Popen(
        [sys.executable, "-c", NATIVE_WARM], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, preexec_fn=lambda: os.nice(10))


def host_cpu():
    """The host's CPU model (``/proc/cpuinfo``, and ``lscpu``'s vendor,
    model name, family and model where ``/proc`` says "unknown"), its
    logical CPUs and those this process may run on, ``OMP_NUM_THREADS``
    and the compiler of the native route."""
    import os
    import subprocess
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.startswith("model name"):
                    model = ln.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    lscpu = {}
    try:
        r = subprocess.run(["lscpu"], capture_output=True, text=True,
                           timeout=10)
        for ln in r.stdout.splitlines():
            k, _, v = ln.partition(":")
            if k.strip() in ("Vendor ID", "Model name", "CPU family",
                             "Model", "Flags") and v.strip():
                lscpu[k.strip()] = v.strip() if k.strip() != "Flags" \
                    else " ".join(f for f in v.split()
                                  if f.startswith("avx"))
    except (OSError, subprocess.SubprocessError):
        pass
    return dict(model=model, lscpu=lscpu, cpus=os.cpu_count(),
                usable=len(os.sched_getaffinity(0)),
                omp_num_threads=os.environ.get("OMP_NUM_THREADS"),
                cxx=os.environ.get("CXX"))


def hh_f32(dev, smi, hh, hh_hits):
    """Phase 27 (a): the HH Poincare batch in f32 (tol the f32 epsilon) at
    10,240 lanes to t = 20: B4-f32 alone, f32 isolation, the hits of 64
    lanes against the port's f32 CPU run and of every lane against phase
    18's f64 run on the card (its hits before t = 20), the energy drift,
    lane-steps/s beside phase 18's f64 event rate."""
    sys_, y = hh_sys()
    kw = dict(dtype=np.float32)

    def make(ics, d, rec):
        return ht.taylor_adaptive_batch(
            sys_, ics, device=d, nt_events=[ht.nt_event(
                y, rec, direction=ht.EventDirection.positive)], **kw)

    make(hh_lanes(CHUNK), dev, HitArrays()).propagate_until(1.0)
    ics = hh_lanes(HH_B)
    rec = HitArrays()
    zero_launches()
    ta, res, wall = timed_call(lambda: make(ics, dev, rec),
                               lambda t: t.propagate_until(HH27_T))
    launches = dict(jk.LAUNCHES)
    eng = ta.engine_report()
    check(eng["jet"] == "hy_phase_f32"
          and eng["propagate_engine"] == "events", f"HH f32: route {eng}")
    check(only(launches, "phase_f32"), f"HH f32: kernels {launches}")
    check(ta._tc.dtype == ta._state.dtype == torch.float32
          and ta._ev is not None, "HH f32: not f32")
    oc, _, _, ns = res
    check(all(o == ht.TaylorOutcome.time_limit for o in oc)
          and bool((ta.time == HH27_T).all()), "HH f32: landing")
    e0 = hh_energy(torch.as_tensor(ics, device=dev))
    drift = float(((hh_energy(torch.as_tensor(ta.state, device=dev)
                              .double()) - e0).abs() / e0.abs()).max())
    check(drift <= HH27_DRIFT_MAX, f"HH f32: energy drift {drift}")
    ts, sg, ln = rec.arrays()
    check(ts.size > 0 and bool((sg == 1).all()), "HH f32: hits")
    # 64 lanes against the f32 CPU run
    ref = HitArrays()
    make(ics[:HH_REF_LANES], "cpu", ref).propagate_until(HH27_T)
    mine, cpu = rec.per_lane(HH_REF_LANES), ref.per_lane(HH_REF_LANES)
    check(all(a[0].size == b[0].size and np.array_equal(a[1], b[1])
              for a, b in zip(mine, cpu)),
          "HH f32: hits differ from the f32 CPU run in count or sign")
    dt_cpu = max(float(np.abs(a[0] - b[0]).max(initial=0.0))
                 for a, b in zip(mine, cpu))
    check(dt_cpu <= HH27_HIT_ATOL, f"HH f32: hit times vs CPU {dt_cpu}")
    # every lane against phase 18's f64 hits before t = 20 (a hit within
    # the bar of t = 20 may fall on either side)
    ft, fs, fl = hh_hits
    keep = ft < HH27_T
    f64 = HitArrays()
    f64.parts.append((ft[keep], fs[keep], fl[keep]))
    a_all, b_all = rec.per_lane(HH_B), f64.per_lane(HH_B)
    n_edge, dt_f64 = 0, 0.0
    for a, b in zip(a_all, b_all):
        if a[0].size != b[0].size:
            near = min(np.abs(np.concatenate([a[0], b[0]]) - HH27_T))
            check(abs(a[0].size - b[0].size) == 1
                  and near <= HH27_HIT_ATOL,
                  f"HH f32: hit count vs f64 {a[0].size} {b[0].size}")
            n_edge += 1
            m = min(a[0].size, b[0].size)
            a, b = (a[0][:m], a[1][:m]), (b[0][:m], b[1][:m])
        check(np.array_equal(a[1], b[1]), "HH f32: a sign differs from f64")
        dt_f64 = max(dt_f64, float(np.abs(a[0] - b[0]).max(initial=0.0)))
    check(dt_f64 <= HH27_HIT_ATOL, f"HH f32: hit times vs f64 {dt_f64}")
    steps = int(ns.sum())
    f64_rate = float(np.median(hh[f"B{HH_B}"]["events_steps_per_s"]))
    return dict(B=HH_B, t_end=HH27_T, order=ta.order, tol=ta.tol,
                engine=eng, launches=launches, lockstep_steps=int(ns.max()),
                lane_steps=steps, wall_s=wall, steps_per_s=steps / wall,
                f64_phase18_steps_per_s=f64_rate,
                rate_vs_f64=(steps / wall) / f64_rate, crossings=int(ts.size),
                energy_drift_max_rel=drift, cpu_ref_lanes=HH_REF_LANES,
                cpu_hit_dt_max=dt_cpu, f64_hit_dt_max=dt_f64,
                f64_edge_lanes=n_edge, hit_atol=HH27_HIT_ATOL,
                nvidia_smi=smi), launches


def var_f32(dev, smi):
    """Phase 27 (b): config 4's PCR3BP STM batch in f32 at 2,048 lanes to
    t = 10 on B4-f32: |det STM - 1|, the Taylor map (f64 from the f32
    state, as the JAX package evaluates it) and the states against the
    f64 run on the card and the f32 CPU run of 16 lanes."""
    vsys = ht.var_ode_sys(ht.models.pcr3bp(mu=VAR_MU), ht.VarArgs.vars,
                          order=1)
    ics = var_lanes(VAR27_B)
    d = np.array([TM_D, 0.0, 0.0, 0.0])
    warm = ht.taylor_adaptive_batch(vsys, ics[:CHUNK], device=dev,
                                    dtype=np.float32)
    warm.propagate_until(1.0)
    ta = ht.taylor_adaptive_batch(vsys, ics, device=dev, dtype=np.float32)
    eng = ta.engine_report()
    check(eng["jet"] == "hy_phase_f32" and ta.is_variational,
          f"config 4 f32: route {eng}")
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    oc, _, _, ns = ta.propagate_until(VAR_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(jk.LAUNCHES)
    check(only(launches, "phase_f32"), f"config 4 f32: kernels {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in oc)
          and bool((ta.time == VAR_T).all()), "config 4 f32: landing")
    st = ta.state
    check(st.dtype == np.float32 and bool(np.isfinite(st).all()),
          "config 4 f32: state")
    stm = torch.as_tensor(st[:, ta.get_vslice(1)].astype(np.float64),
                          device=dev).reshape(VAR27_B, 4, 4)
    det_err = float((torch.linalg.det(stm) - 1.0).abs().max())
    check(det_err <= VAR27_DET, f"config 4 f32: |det STM - 1| {det_err}")
    tm = ta.eval_taylor_map(d)
    check(tm.dtype == np.float64, "config 4 f32: the Taylor map's dtype")
    t64 = ht.taylor_adaptive_batch(vsys, ics, device=dev, tol=TOL,
                                   high_accuracy=True)
    t64.propagate_until(VAR_T)
    tm64 = t64.eval_taylor_map(d)
    rel64, tm_rel64 = rel_max(st, t64.state), rel_max(tm, tm64)
    check(rel64 <= VAR27_F64_RTOL and tm_rel64 <= VAR27_F64_RTOL,
          f"config 4 f32 vs f64: {rel64}, Taylor map {tm_rel64}")
    cpu = ht.taylor_adaptive_batch(vsys, ics[:16], device="cpu",
                                   dtype=np.float32)
    cpu.propagate_until(VAR_T)
    rel_cpu = rel_max(st[:16], cpu.state)
    tm_cpu = rel_max(tm[:16], cpu.eval_taylor_map(d))
    check(rel_cpu <= VAR27_CPU_RTOL and tm_cpu <= VAR27_CPU_RTOL,
          f"config 4 f32 vs the f32 CPU run: {rel_cpu}, map {tm_cpu}")
    steps = int(ns.sum())
    return dict(B=VAR27_B, t_end=VAR_T, order=ta.order, engine=eng,
                launches=launches, wall_s=wall, lane_steps=steps,
                steps_per_s=steps / wall, det_max_err=det_err,
                vs_f64_max_rel=rel64, taylor_map_vs_f64_max_rel=tm_rel64,
                cpu_ref_lanes=16, vs_cpu_max_rel=rel_cpu,
                taylor_map_vs_cpu_max_rel=tm_cpu, nvidia_smi=smi), launches


def elp_f32(dev, smi):
    """Phase 27 (c): the complete ELP2000 ODE in f32 at 10,240 lanes over
    0.002 centuries (S1 in f64 on the widened f32 input, its orders
    rounded once into B4-f32's buffer) against the f64 card runs at the
    same tol and at 1e-15 and the f32 CPU run of 4 lanes; then phase 25
    (c)'s ``pm_x`` ODE in f32 against its f64 run and the CPU's."""
    sys_ = elp_sys(ht, 0.0)
    t0 = series_times(ELP27_B, 0)
    eps32 = float(np.finfo(np.float32).eps)

    def run(d, B, **kw):
        return ht.taylor_adaptive_batch(sys_, np.zeros((B, 3)), time=t0[:B],
                                        device=d, **kw)

    ta = run(dev, ELP27_B, dtype=np.float32)
    eng = ta.engine_report()
    check(eng["jet"] == "hy_phase_f32"
          and eng["series"] == sj.REPORT, f"ELP f32: route {eng}")
    torch.cuda.synchronize()
    zero_launches()
    w0 = time.perf_counter()
    res = ta.propagate_for(ELP27_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    launches = dict(jk.LAUNCHES)
    check(only(launches, "phase_f32", "series_lin", "series_gen"),
          f"ELP f32: kernels {launches}")
    check(all(o == ht.TaylorOutcome.time_limit for o in res[0])
          and bool(np.isfinite(ta.state).all()), "ELP f32: outcomes")
    st = ta.state.astype(np.float64)
    same = run(dev, ELP27_B, tol=eps32)
    same.propagate_for(ELP27_T)
    f64 = run(dev, ELP27_B, tol=TOL)
    f64.propagate_for(ELP27_T)
    cpu = run("cpu", ELP27_REF_LANES, dtype=np.float32)
    cpu.propagate_for(ELP27_T)
    scale = float(np.abs(f64.state).max())
    d_same = float(np.abs(st - same.state).max())
    d_f64 = float(np.abs(st - f64.state).max())
    d_same64 = float(np.abs(same.state - f64.state).max())
    d_cpu = float(np.abs(st[:ELP27_REF_LANES] - cpu.state).max())
    check(d_f64 <= ELP27_ABS and d_same <= ELP27_ABS,
          f"ELP f32 vs f64 at 1e-15 {d_f64}, at its tol {d_same}")
    check(d_cpu <= ELP27_RTOL * scale, f"ELP f32 vs the CPU: {d_cpu}")
    steps = int(np.asarray(res[3]).sum())
    # the pm_x ODE in f32
    x = ht.make_vars("x")
    t1, t2 = ht.utils.jd_utc_to_tt(ht.utils.cal_to_jd(2020, 1, 1), 0.0)
    tp0 = float(((t1 - 2451545.0) + t2) / 36525.0)
    pm = {}
    for name, d, kw in (("f32", dev, dict(dtype=np.float32)),
                        ("f64", dev, dict(tol=1e-12)),
                        ("cpu_f32", "cpu", dict(dtype=np.float32))):
        s = ht.taylor_adaptive([(x, ht.models.pm_x() * 1e6)], [0.0],
                               time=tp0, device=d, **kw)
        if name == "f32":
            zero_launches()
        oc = s.propagate_until(tp0 + 2.0 / 36525.0,
                               max_delta_t=0.02 / 36525.0)[0]
        check(oc == ht.TaylorOutcome.time_limit, f"pm_x {name}: {oc}")
        if name == "f32":
            pm_launch = dict(jk.LAUNCHES)
            check(only(pm_launch, "phase_f32"), f"pm_x f32: {pm_launch}")
        pm[name] = float(s.state[0])
    check(abs(pm["f32"] - pm["f64"]) <= PMX27_ABS
          and abs(pm["f32"] - pm["cpu_f32"]) <= PMX27_ABS,
          f"pm_x f32: {pm}")
    return dict(B=ELP27_B, t_span=ELP27_T, order=ta.order, engine=eng,
                launches=launches, wall_s=wall, lane_steps=steps,
                lane_steps_per_s=steps / wall, max_abs_state=scale,
                vs_f64_same_tol_max_abs=d_same, vs_f64_max_abs=d_f64,
                f64_same_tol_vs_f64_max_abs=d_same64,
                cpu_ref_lanes=ELP27_REF_LANES, vs_cpu_max_abs=d_cpu,
                bars=dict(f64_abs=ELP27_ABS, rtol=ELP27_RTOL),
                pm_x=dict(pm, launches=pm_launch, abs_bar=PMX27_ABS),
                nvidia_smi=smi), launches, pm_launch


def no_device_work(fn):
    """``fn()`` under ``torch.profiler`` with the card's activity: its
    result, its wall seconds and the device events it caused."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    zero_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, wall, len(ev)


def native_paths(dev, smi, sys_ss, ics_ss, warm_proc):
    """Phase 27 (d): ``backend="native"`` on the card's host: one outer-SS
    lane's ``step()`` latency on the host beside the device's (phase 20's
    measure), ``propagate_until(100)`` at 8, 64 and 256 lanes on the host
    and on the card, the states held to each other and the landing
    exact, no kernel launched and no device event during the native
    runs (``torch.profiler``), the host's CPU."""
    out, err = warm_proc.communicate(timeout=600)
    check(warm_proc.returncode == 0, f"native build: {err[-2000:]}")
    build = json.loads(out.strip().splitlines()[-1])
    check(build["ok"], f"native build: {build}")
    kw = dict(tol=TOL, high_accuracy=True)
    t0 = time.perf_counter()
    tn = ht.taylor_adaptive(sys_ss, ics_ss[0], backend="native", **kw)
    load_s = time.perf_counter() - t0
    check(tn.backend == "native"
          and tn.engine_report()["propagate_engine"] == "native-cg",
          f"native scalar: {tn.engine_report()}")
    lat_n, w, n_ev = no_device_work(lambda: step_latency(tn))
    check(n_ev == 0 and not any(jk.LAUNCHES.values()),
          f"native step(): {n_ev} device events, {dict(jk.LAUNCHES)}")
    td = ht.taylor_adaptive(sys_ss, ics_ss[0], device=dev, **kw)
    lat_d = step_latency(td)
    e_ref = energy(torch.as_tensor(ics_ss[:max(NATIVE_B)], device=dev),
                   MASSES, GCONST)
    rows = {}
    for B in NATIVE_B:
        st0 = ics_ss[:B]
        nb = ht.taylor_adaptive_batch(sys_ss, st0, backend="native", **kw)
        check(nb.engine_report()["propagate_engine"] == "native-cg",
              f"native batch: {nb.engine_report()}")
        nb.step()
        nb = ht.taylor_adaptive_batch(sys_ss, st0, backend="native", **kw)
        res_n, wall_n, n_ev = no_device_work(
            lambda: nb.propagate_until(T_END))
        check(n_ev == 0 and not any(jk.LAUNCHES.values()),
              f"native B={B}: {n_ev} device events, {dict(jk.LAUNCHES)}")
        warm = ht.taylor_adaptive_batch(sys_ss, st0, device=dev, **kw)
        warm.propagate_until(1.0)
        db, res_d, wall_d = timed_call(
            lambda: ht.taylor_adaptive_batch(sys_ss, st0, device=dev, **kw),
            lambda t: t.propagate_until(T_END))
        for r, t in ((res_n, nb), (res_d, db)):
            check(all(o == ht.TaylorOutcome.time_limit for o in r[0])
                  and bool((t.time == T_END).all()),
                  f"native B={B}: landing")
        rel = rel_max(nb.state, db.state)
        check(rel <= REF_RTOL, f"native B={B} against the card: {rel}")
        drift = float(((energy(torch.as_tensor(nb.state, device=dev),
                               MASSES, GCONST) - e_ref[:B]).abs()
                       / e_ref[:B].abs()).max())
        check(drift <= DRIFT_MAX, f"native B={B}: energy drift {drift}")
        sn, sd = int(np.asarray(res_n[3]).sum()), int(np.asarray(
            res_d[3]).sum())
        rows[f"B{B}"] = dict(
            native_wall_s=wall_n, native_steps_per_s=sn / wall_n,
            device_wall_s=wall_d, device_steps_per_s=sd / wall_d,
            native_over_device=(sn / wall_n) / (sd / wall_d),
            lane_steps=sn, device_lane_steps=sd, max_rel=rel,
            energy_drift_max_rel=drift)
    return dict(build=build, load_s=load_s, host=host_cpu(),
                step_ms_native=lat_n,
                steps_per_s_native=1e3 / lat_n["median"],
                step_ms_device=lat_d, steps_per_s_device=1e3 / lat_d[
                    "median"], latency_device_over_native=lat_d["median"]
                / lat_n["median"],
                propagate_until=rows, t_end=T_END, nvidia_smi=smi)


def c4_native_paths(dev, smi, sys_ss, ics_ss, hh, hh_hits, warm_proc):
    """Phase 27: float32 on the rest of C.4 (the HH events, config 4's
    STM, the complete ELP2000 and the pm_x ODE) and the native host
    runtime.  Returns the launches on each path, by kernel counter."""
    t0 = time.perf_counter()
    line_a, la = hh_f32(dev, smi, hh, hh_hits)
    say("27a", **line_a)
    line_b, lb = var_f32(dev, smi)
    say("27b", **line_b)
    line_c, lc, lp = elp_f32(dev, smi)
    say("27c", **line_c)
    line_d = native_paths(dev, smi, sys_ss, ics_ss, warm_proc)
    say("27d", phase_s=time.perf_counter() - t0, **line_d)
    return dict(hh_f32_events=la, var_pcr3bp_f32=lb, elp2000_f32=lc,
                pm_x_f32=lp)


def phase27_alone():
    """Phase 27 alone on the card (``python3 -c "import chip_smoke as cs;
    cs.phase27_alone()"``), phase 18's f64 hits made anew at 10,240 lanes
    to t = 20 and its rate from that run."""
    _build.load()
    warm = start_native_build()
    try:
        dev, smi = torch.device("cuda"), smi_line()
        print(smi, flush=True)
        rec = HitArrays()
        hh_batch(hh_lanes(CHUNK), dev, HitArrays()).propagate_until(1.0)
        _, r, wall = timed_call(lambda: hh_batch(hh_lanes(HH_B), dev, rec),
                                lambda t: t.propagate_until(HH27_T))
        hh = {f"B{HH_B}": {"events_steps_per_s": [int(r[3].sum()) / wall]}}
        out = c4_native_paths(dev, smi, nbody(6, masses=MASSES,
                                              Gconst=GCONST),
                              lanes(IC, B_MAIN, 0), hh, rec.arrays(), warm)
    finally:
        if warm.poll() is None:
            warm.kill()
            warm.communicate()
    print(json.dumps(out), flush=True)

if __name__ == "__main__":
    main()
