#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA device and ``nvcc`` (the kernels are built from
``heyoka_tpu_torch/csrc`` into ``build/`` on first use), and exits non-zero
if anything is missing or any check fails.  Phases, one line each:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of the kernels, with its time, ptxas's register counts per
   kernel instance (B1/B2 come in one instance per lanes-a-block and
   layout) and the dynamic shared memory a block of B1/B2 takes on the
   outer-Solar-System tape (``jet_kernels.block_layout``);
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
   block shape they take (1, 2 or 3 lanes x 128 or 256 threads), equal
   bit for bit to the default's, with their times and the fastest;
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

The line before the last is the kernels' JSON summary (each kernel's
launches on its path, its error against its plain version, its time, its
plain version's, its bound from ``tools.roofline`` and, where one torch
call computes the same function, that call's time); the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import re
import sys
import time

import numpy as np
import torch

import heyoka_tpu_torch as ht
from heyoka_tpu_torch import _build
from heyoka_tpu_torch.models import nbody
from heyoka_tpu_torch.taylor import jet_kernels as jk
from heyoka_tpu_torch.taylor import jet_phase as jp
from heyoka_tpu_torch.taylor import jet_rolled as jr
from heyoka_tpu_torch.taylor.compact import build_plan
from heyoka_tpu_torch.taylor.stepper import taylor_order_from_tol
from heyoka_tpu_torch.tools import (
    GCONST, IC, MASSES, cuda_ms, graph_ms, mascon_body, mascon_lanes,
    microbench_conv, proto_phase, smi_line,
)
from heyoka_tpu_torch.tools import roofline as rl
from heyoka_tpu_torch.tools.cases import (
    pendulum_lanes, phase_cases, phase_lanes,
)

TOL = 1e-15
B_CHECK = 256
B_MAIN = 10_240
T_END = 100.0
CHUNK = 64
FAR = 1000.0  # remaining time of the lone chunks: no lane nears its target
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

SOURCES = {"hy_jet_f64": "heyoka_tpu_torch/csrc/taylor_jet.cu",
           "hy_prop_f64": "heyoka_tpu_torch/csrc/taylor_jet.cu",
           "hy_jet_rolled_f64": "heyoka_tpu_torch/csrc/taylor_jet_rolled.cu",
           "hy_phase_f64": "heyoka_tpu_torch/csrc/taylor_phase.cu",
           "hy_conv_f32": "heyoka_tpu_torch/csrc/conv_microbench.cu",
           "hy_conv_dd": "heyoka_tpu_torch/csrc/conv_microbench.cu",
           "hy_proto_phase_f32": "heyoka_tpu_torch/csrc/proto_phase.cu"}
REPLACES = {"hy_jet_f64": "heyoka_tpu/taylor/pallas_phase.py:1604",
            "hy_prop_f64": "heyoka_tpu/taylor/pallas_phase.py:2454",
            "hy_jet_rolled_f64": "heyoka_tpu/taylor/pallas_phase.py:1842",
            "hy_phase_f64": "heyoka_tpu/taylor/pallas_phase.py:899",
            "hy_conv_f32": "tools/microbench_pallas_conv.py:48",
            "hy_conv_dd": "tools/microbench_pallas_conv.py:92",
            "hy_proto_phase_f32": "tools/proto_pallas_phase.py:240"}
#: the kernels' names in ptxas's log, longest first where one name holds
#: another
PTXAS_NAMES = ("jet_rolled_kernel", "jet_kernel", "prop_kernel",
               "proto_phase_kernel", "phase_kernel", "conv_f32_kernel",
               "conv_dd_ring", "conv_dd_direct")
#: block shapes of B1/B2 with the jets in shared memory timed in phase 6
SWEEP_LANES = (1, 2, 3)
SWEEP_THREADS = (128, 256)


def ptxas_name(line):
    """A kernel's name in a ptxas line, with its template arguments
    (``jet_kernel<3,smem>``, ``phase_kernel<global>``, the staging alone
    ``phase_kernel<smem,stage>``, T1-dd's trace instance
    ``conv_dd_ring<trace>``) where it has them."""
    fn = next(w for w in PTXAS_NAMES if w in line)
    if fn == "conv_dd_ring":
        return fn + ("<trace>" if fn + "ILb1E" in line else "")
    m = re.search(fn + r"ILi(\d+)ELb([01])E", line)
    if m:
        fn += f"<{m.group(1)},{'smem' if m.group(2) == '1' else 'global'}>"
    m = re.search(fn + r"I((?:Lb[01]E)+)E", line)
    if m:
        flags = re.findall(r"Lb([01])E", m.group(1))
        fn += "<" + ("smem" if flags[0] == "1" else "global") + (
            ",stage" if flags[1:] == ["0"] else "") + ">"
    return fn


def say(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


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
    layout = jk.layout_report(tape)
    # the dynamic shared memory of a B1/B2 block on the outer-SS tape, the
    # tables included, and the blocks an SM holds; phase 7 gives
    # mascon-512's (the global layout)
    launch_smem = jk._launch_cfg(tape, B_MAIN, dev)[2]
    say(2, build_s=build_s, ptxas=ptxas,
        smem_per_block=dict(layout, threads=jk.THREADS,
                            launch_bytes=launch_smem,
                            blocks_per_sm=jk.blocks_per_sm(launch_smem,
                                                           jk.THREADS)))
    n_eq = tape.n_eq
    no_pars = torch.zeros((0, B_CHECK), dtype=torch.float64, device=dev)

    # -- 3. B2 against jet_plain ------------------------------------------------
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

    # -- 4. B1 against prop_plain -----------------------------------------------
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

    # -- 5. the slice -------------------------------------------------------------
    ics = lanes(IC, B_MAIN, 0)
    kw = dict(tol=TOL, high_accuracy=True)
    warm = ht.taylor_adaptive_batch(sys_, ics[:CHUNK], device=dev, **kw)
    warm.propagate_until(1.0)
    ta = ht.taylor_adaptive_batch(sys_, ics, device=dev, **kw)
    e0 = energy(torch.as_tensor(ics, device=dev), MASSES, GCONST)
    torch.cuda.synchronize()
    for k in jk.LAUNCHES:
        jk.LAUNCHES[k] = 0
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

    # -- 6. kernel vs plain at 10,240 lanes -----------------------------------------
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
    say(6, B=B_MAIN, chunk_steps=CHUNK, nvidia_smi=smi,
        jet_max_rel_per_order=rel_m, prop_state_max_rel=prop_rel_m,
        **{name: dict(times[name], ms_runs=t[name][0],
                      plain_ms_runs=t[name][1], **bounds[name])
           for name in runs}, block_shapes=shapes)

    rolled = huge_tapes(dev, order, smi)
    phased = phase_tapes(dev, order, smi)
    convs = conv_tool(dev, smi)
    proto = proto_tool(dev, smi)

    rows = [("hy_jet_f64", launches["jet"], jet_err, times["jet"]),
            ("hy_prop_f64", launches["prop"], prop_err, times["prop"]),
            ("hy_jet_rolled_f64", *rolled),
            ("hy_phase_f64", *phased),
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


def fused_route(sys_, orbits, st_rolled, dev):
    """Phase 8's lanes and horizon through the fused route (kernel B1 on
    the layout the tape takes, B2 for the first step and the landing:
    ``ROLLED_MIN_WIDTH`` raised above the tape's width while the
    integrators are built), after phase 8's launch counts were read: its
    lane-steps/s beside the rolled route's (ROADMAP A.16); every lane
    lands on the target and the states agree with the rolled route's to
    ``REF_RTOL``."""
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
    check(eng["prop"] == "hy_prop_f64",
          f"phase 8: not the fused route: {eng}")
    warm.propagate_until(1.0)
    n0 = dict(jk.LAUNCHES)
    tf.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oc, _, _, nsteps = tf.propagate_until(MASCON_T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(o == ht.TaylorOutcome.time_limit for o in oc)
          and bool((tf.time == MASCON_T).all()),
          "phase 8, fused route: a lane did not land on the target")
    rel = float(np.abs(tf.state - st_rolled).max()
                / np.abs(st_rolled).max())
    check(rel <= REF_RTOL, f"phase 8, fused route vs rolled: {rel}")
    steps = int(nsteps.sum())
    return dict(wall_s=wall, lane_steps=steps, steps_per_s=steps / wall,
                launches={k: jk.LAUNCHES[k] - n0[k] for k in ("jet", "prop")},
                max_rel_vs_rolled=rel, layout=eng["layout"])


def block_shapes(tape, st, pars, aux, auxi, jet_ref, prop_ref):
    """B2 and a 64-step B1 chunk at every block shape of
    ``SWEEP_LANES`` x ``SWEEP_THREADS`` with the jets in shared memory:
    each shape computes every item the same way, so its outputs must equal
    the default shape's (``jet_ref``, ``prop_ref``) bit for bit.  Returns
    the times, the fastest shape by B1's time, and the shape in use."""
    res = {}
    for L in SWEEP_LANES:
        for nt in SWEEP_THREADS:
            def jet_run():
                return jk._jet_cuda(tape, st, pars, None, L, nt)

            def prop_run():
                return jk._prop_cuda(tape, st, pars, aux, auxi, CHUNK, True,
                                     L, nt)

            same = all(torch.equal(a, b) for a, b in zip(
                (*jet_run(), *prop_run()), (*jet_ref, *prop_ref)))
            check(same, f"B1/B2 with {L} lanes x {nt} threads differ from "
                  "the default block shape")
            smem = jk._launch_cfg(tape, st.shape[1], st.device, L, nt)[2]
            res[f"{L}x{nt}"] = dict(jet_ms=cuda_ms(jet_run, 3),
                                    prop_ms=cuda_ms(prop_run, 2),
                                    launch_smem_bytes=smem,
                                    blocks_per_sm=jk.blocks_per_sm(smem, nt))
    return dict(times=res, fastest_prop=min(
        res, key=lambda c: res[c]["prop_ms"]), fastest_jet=min(
        res, key=lambda c: res[c]["jet_ms"]),
        chosen=f"{jk.LANES}x{jk.THREADS}")


def huge_tapes(dev, order, smi):
    """Phases 7-9, the huge-tape path: kernel B3 against its twin and B2,
    the mascon-512 slice, and the jets' times.  Returns B3's launches in
    the slice, its largest abs error against the twin, and its times."""
    f64 = dict(dtype=torch.float64, device=dev)
    kw, rng = mascon_body(MASCON_N)
    ics = mascon_lanes(rng, MASCON_B)
    orbits = mascon_lanes(mascon_body(MASCON_N)[1], MASCON_B, kw["omega"])
    rtape, dtape = mascon_tapes(kw, order, dev)

    def jet_args(st):
        B = st.shape[0]
        return (torch.as_tensor(st.T.copy(), device=dev),
                torch.zeros((0, B), **f64), torch.zeros(B, **f64))

    # -- 7. B3 against jet_rolled_plain and B2 ------------------------------------
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

    # -- 8. the slice: mascon-512 at 1,024 lanes ----------------------------------
    sys_ = ht.models.mascon(**kw)
    ta = ht.taylor_adaptive_batch(sys_, orbits, device=dev, tol=TOL,
                                  high_accuracy=True)
    eng = ta.engine_report()
    check(eng["jet"] == "hy_jet_rolled_f64"
          and eng["propagate_engine"] == "flat",
          f"mascon-512: not the rolled route: {eng}")
    j0 = jacobi(torch.as_tensor(orbits, device=dev), kw)
    torch.cuda.synchronize()
    for k in jk.LAUNCHES:
        jk.LAUNCHES[k] = 0
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

    # -- 9. times: B3, its twin and B2 at 1,024 lanes -----------------------------
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
    return launches["jet_rolled"], rolled_err, dict(
        timed(t["b3"], t["plain"], bnd), layout=rep["layout"],
        smem_bytes=rep["smem_bytes"], threads=rep["threads"])


def pendulum_energy(st):
    """``models.pendulum_energy`` at g = 9.8, l = m = 1, per lane."""
    return 0.5 * st[:, 1] * st[:, 1] + 9.8 * (1.0 - torch.cos(st[:, 0]))


def lane_tensors(st, pars, t, dev):
    """Lanes as :func:`phase_lanes` gives them -> the jets' arguments
    ``(state (n, B), pars (n_pars, B), t (B,))`` on ``dev``."""
    f = dict(dtype=torch.float64, device=dev)
    return (torch.as_tensor(st.T.copy(), **f),
            torch.as_tensor(pars.T.copy(), **f), torch.as_tensor(t, **f))


def seeded_buffer(tape, st, pars, t, dev):
    """The ``(K+1, W, B)`` buffer with order 0 of every column and the
    virtual columns seeded: what kernel B4 starts from."""
    tc = jk._seed_plain(tape, *lane_tensors(st, pars, t, dev))
    jp.order0(tape, tc)
    return tc


def phase_tapes(dev, order, smi):
    """Phases 10-12, the phase route: kernel B4 against its twin on every
    tape, the pendulum slice, and the times.  Returns B4's launches in
    the slice, its largest abs error against the twin, and its times."""
    def rel(a, b):  # (K+1, W, B) buffers, per order
        return per_order_rel(a.permute(1, 0, 2), b.permute(1, 0, 2))

    # -- 10. B4 against phase_plain on every tape -------------------------------
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
    missing = sorted(set(ht.PHASE_OPS) - ops)
    check(not missing, f"phase 10 ran no tape with {missing}")
    say(10, B=PHASE_B, order=order, lo=[1, PHASE_LO], tol=JET_RTOL,
        opcodes=sorted(ops, key=ht.OPCODES.index), max_rel_per_order=max(
            max(v["lo1"], v["lo9"]) for v in res.values()),
        max_abs_err=phase_err, tapes=res)

    # -- 11. the slice: the pendulum at 10,240 lanes ------------------------------
    sys_ = ht.models.pendulum()
    ics = pendulum_lanes(PEND_B, 0)
    kw = dict(tol=TOL, high_accuracy=True)
    warm = ht.taylor_adaptive_batch(sys_, ics[:CHUNK], device=dev, **kw)
    warm.propagate_until(1.0)
    ta = ht.taylor_adaptive_batch(sys_, ics, device=dev, **kw)
    eng = ta.engine_report()
    check(eng == dict(device=str(dev), jet="hy_phase_f64",
                      propagate_engine="flat", prop=None, layout=None),
          f"pendulum: not the phase route: {eng}")
    e0 = pendulum_energy(torch.as_tensor(ics, device=dev))
    torch.cuda.synchronize()
    for k in jk.LAUNCHES:
        jk.LAUNCHES[k] = 0
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

    # -- 12. times: B4 against phase_plain, per block shape ---------------------
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
    return launches["phase"], phase_err, dict(
        timed(tm["ms_runs"], tm["plain_ms_runs"], tm),
        **{k: tm["shape"][k] for k in ("layout", "lanes", "threads",
                                       "smem")})


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
    for k in jk.LAUNCHES:
        jk.LAUNCHES[k] = 0
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
    for k in jk.LAUNCHES:
        jk.LAUNCHES[k] = 0
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


if __name__ == "__main__":
    main()
