#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA device and ``nvcc`` (the kernels are built from
``heyoka_tpu_torch/csrc`` into ``build/`` on first use), and exits non-zero
if anything is missing or any check fails.  Phases, one line each:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. the build of the kernels, with its time and ptxas's register counts;
3. kernel B2 (``hy_jet_f64``) against ``jet_plain`` on the card: the
   outer-Solar-System tape at order 19 and 256 lanes; coefficients agree
   to 1e-13 relative per order (normalised by the order's max over lanes);
4. kernel B1 (``hy_prop_f64``) against ``prop_plain``: the same lanes,
   one 64-step chunk; per-lane step counts and flags equal, state within
   1e-11 relative;
5. the slice: ``taylor_adaptive_batch(nbody(6), ..., tol=1e-15,
   high_accuracy=True, device="cuda")`` at 10,240 lanes,
   ``propagate_until(100.0)``: every lane lands on t = 100 exactly with
   ``time_limit``, both kernels ran, the relative energy drift is at most
   1e-12, and 4 lanes agree with the port's CPU run of the same lanes;
6. the time of one B2 launch and one 64-step B1 chunk at 10,240 lanes
   against their plain twins on the card (CUDA events), and the phase 3
   and 4 comparisons again at that width;
7. kernel B3 (``hy_jet_rolled_f64``) on the mascon-512 tape of
   ``benchmarks/mascon_bench.py`` at order 19 and 256 of its lanes,
   against ``jet_rolled_plain`` and against B2 on the same inputs: 1e-13
   relative per order, norms to the same bound;
8. the huge-tape slice: ``taylor_adaptive_batch(mascon(...), ...,
   tol=1e-15, high_accuracy=True, device="cuda")`` at 1,024 lanes on
   bound r ~ 2 orbits (``mascon_lanes``), one ``step()`` and
   ``propagate_until(T)`` over two orbital periods: the rolled route,
   only B3 launched, every lane on
   t = T exactly with ``time_limit``, the rotating-frame Jacobi integral
   kept to 1e-12, and 2 lanes agreeing with the port's CPU run;
9. the time of one B3 jet at 1,024 lanes on mascon-512 against
   ``jet_rolled_plain`` and B2, and B2 against B3 on mascon-32/128/256
   and on the outer-Solar-System tape (the data behind
   ``taylor.batch.ROLLED_MIN_WIDTH``);
10. kernel B4 (``hy_phase_f64``) against ``phase_plain`` on the card, on
    the tapes of :func:`phase_cases` (the pendulum, five mixed systems,
    two more for the hyperbolic and logical ops, and one system per op),
    which together hold every op of ``convert.PHASE_OPS``: order 19,
    1,024 lanes, from ``lo = 1`` and from ``lo = 9`` on a buffer whose
    lower orders came from the twin; 1e-13 relative per order, norms to
    the same bound;
11. the pendulum slice: ``taylor_adaptive_batch(pendulum(), ...,
    tol=1e-15, high_accuracy=True, device="cuda")`` at 10,240 librating
    lanes, ``propagate_until(100.0)``: only B4 launched, every lane on
    t = 100 exactly with ``time_limit``, the relative energy drift at
    most 1e-12, 4 lanes agreeing with the port's CPU run; then its first
    10 time units again, without and with ``torch.profiler``, for the
    device's busy and idle shares;
12. the time of B4 against ``phase_plain`` on the card: 10,240 pendulum
    lanes and 1,024 lanes of the widest mixed tape, with one whole
    ``jet_phase`` beside each.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

import bench  # the north-star constants (MASSES, GCONST, IC); numpy only
import heyoka_tpu_torch as ht
from heyoka_tpu_torch import _build
from heyoka_tpu_torch.models import nbody
from heyoka_tpu_torch.taylor import jet_kernels as jk
from heyoka_tpu_torch.taylor import jet_phase as jp
from heyoka_tpu_torch.taylor import jet_rolled as jr
from heyoka_tpu_torch.taylor.compact import build_plan
from heyoka_tpu_torch.taylor.stepper import taylor_order_from_tol

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

PHASE_B = 1024
PHASE_LO = 9  # the JAX route's split at mp_order = 8
PEND_B = 10_240
PEND_T = 100.0
PROFILE_T = 10.0  # the window of phase 11 timed under the profiler

SOURCES = {"hy_jet_f64": "heyoka_tpu_torch/csrc/taylor_jet.cu",
           "hy_prop_f64": "heyoka_tpu_torch/csrc/taylor_jet.cu",
           "hy_jet_rolled_f64": "heyoka_tpu_torch/csrc/taylor_jet_rolled.cu",
           "hy_phase_f64": "heyoka_tpu_torch/csrc/taylor_phase.cu"}
REPLACES = {"hy_jet_f64": "heyoka_tpu/taylor/pallas_phase.py:1604",
            "hy_prop_f64": "heyoka_tpu/taylor/pallas_phase.py:2454",
            "hy_jet_rolled_f64": "heyoka_tpu/taylor/pallas_phase.py:1842",
            "hy_phase_f64": "heyoka_tpu/taylor/pallas_phase.py:899"}


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


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs."""
    fn()  # warm-up
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main():
    # -- 1. the card --------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
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
            fn = next(w for w in ("jet_rolled_kernel", "jet_kernel",
                                  "prop_kernel", "phase_kernel") if w in ln)
        elif fn and ("registers" in ln or "spill" in ln):
            ptxas.setdefault(fn, []).append(
                ln.split("ptxas info    : ")[-1].strip())
    say(2, build_s=build_s, ptxas=ptxas)

    sys_ = nbody(6, masses=bench.MASSES, Gconst=bench.GCONST)
    order = taylor_order_from_tol(TOL)
    plan = build_plan(ht.taylor_decompose_sys(sys_), order)
    tape = jk.JetTape(ht.plan_to_arrays(plan), dev)
    n_eq = tape.n_eq
    no_pars = torch.zeros((0, B_CHECK), dtype=torch.float64, device=dev)

    # -- 3. B2 against jet_plain ------------------------------------------------
    st = torch.as_tensor(lanes(bench.IC, B_CHECK, 1).T.copy(), device=dev)
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
    say(3, B=B_CHECK, order=order, W=tape.width,
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
    say(4, B=B_CHECK, steps=CHUNK, state_max_rel=prop_rel,
        max_abs_err=prop_err, time_max_rel=acc_rel, tol=PROP_RTOL)

    # -- 5. the slice -------------------------------------------------------------
    ics = lanes(bench.IC, B_MAIN, 0)
    kw = dict(tol=TOL, high_accuracy=True)
    warm = ht.taylor_adaptive_batch(sys_, ics[:CHUNK], device=dev, **kw)
    warm.propagate_until(1.0)
    ta = ht.taylor_adaptive_batch(sys_, ics, device=dev, **kw)
    e0 = energy(torch.as_tensor(ics, device=dev), bench.MASSES, bench.GCONST)
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
    e1 = energy(torch.as_tensor(st_end, device=dev), bench.MASSES,
                bench.GCONST)
    drift = float(((e1 - e0).abs() / e0.abs()).max())
    check(drift <= DRIFT_MAX, f"the slice: energy drift {drift}")
    ref = ht.taylor_adaptive_batch(sys_, ics[:REF_LANES], device="cpu", **kw)
    ref_oc = ref.propagate_until(T_END)[0]
    ref_rel = float(np.abs(st_end[:REF_LANES] - ref.state).max()
                    / np.abs(ref.state).max())
    check(ref_oc == oc[:REF_LANES] and ref_rel <= REF_RTOL,
          f"the slice vs the CPU run: {ref_rel}")
    steps = int(nsteps.sum())
    say(5, B=B_MAIN, t_end=T_END, wall_s=wall, lane_steps=steps,
        steps_per_s=steps / wall, mean_steps_per_lane=steps / B_MAIN,
        launches=launches, energy_drift_max_rel=drift,
        cpu_ref_max_rel=ref_rel, engine=ta.engine_report())

    # -- 6. kernel vs plain at 10,240 lanes -----------------------------------------
    stm = torch.as_tensor(lanes(bench.IC, B_MAIN, 2).T.copy(), device=dev)
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
    times = {}
    for name, (kern, plain) in runs.items():
        p1 = cuda_ms(plain, 1)
        k1 = cuda_ms(kern, 3)
        k2 = cuda_ms(kern, 3)
        p2 = cuda_ms(plain, 1)
        times[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                           ms_runs=[k1, k2], plain_ms_runs=[p1, p2])
    # the same comparisons as phases 3 and 4, at the main path's width
    tc_k, _ = runs["jet"][0]()
    tc_p, _ = runs["jet"][1]()
    rel_m = float(per_order_rel(tc_k, tc_p).max())
    check(rel_m <= JET_RTOL, f"B2 vs jet_plain at B={B_MAIN}: {rel_m}")
    sk, _, oik = runs["prop"][0]()
    sp, _, oip = runs["prop"][1]()
    check(torch.equal(oik, oip), f"B1 vs prop_plain at B={B_MAIN}: flags")
    prop_rel_m = float(((sk - sp).abs().amax(1) / sp.abs().amax(1)).max())
    check(prop_rel_m <= PROP_RTOL,
          f"B1 vs prop_plain at B={B_MAIN}: state {prop_rel_m}")
    jet_err = max(jet_err, float((tc_k - tc_p).abs().max()))
    prop_err = max(prop_err, float((sk - sp).abs().max()))
    say(6, B=B_MAIN, chunk_steps=CHUNK, nvidia_smi=smi,
        jet_max_rel_per_order=rel_m, prop_state_max_rel=prop_rel_m, **times)

    rolled = huge_tapes(dev, order, smi)
    phased = phase_tapes(dev, order, smi)

    rows = [("hy_jet_f64", launches["jet"], jet_err, times["jet"]),
            ("hy_prop_f64", launches["prop"], prop_err, times["prop"]),
            ("hy_jet_rolled_f64", *rolled),
            ("hy_phase_f64", *phased)]
    kernels = [
        dict(name=name, route="cuda", source=SOURCES[name],
             replaces=REPLACES[name], launches=n, max_abs_err=err,
             ms=tm["ms"], plain_ms=tm["plain_ms"])
        for name, n, err, tm in rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


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
    say(7, B=B_CHECK, order=order, W=rtape.width, classes=rtape.sizes,
        vs_plain_max_rel_per_order=rel["plain"],
        vs_b2_max_rel_per_order=rel["b2"], max_abs_err=rolled_err,
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
    say(8, B=MASCON_B, n_mascons=MASCON_N, t_end=MASCON_T, wall_s=wall,
        lane_steps=steps, steps_per_s=steps / wall,
        mean_steps_per_lane=steps / MASCON_B, launches=launches,
        jacobi_drift_max_rel=drift, cpu_ref_max_rel=ref_rel,
        r_end_range=[float(np.linalg.norm(st_end[:, :3], axis=1).min()),
                     float(np.linalg.norm(st_end[:, :3], axis=1).max())],
        engine=eng)

    # -- 9. times: B3, its twin and B2 at 1,024 lanes -----------------------------
    args = jet_args(ics)
    runs = {"b3": lambda: jr.jet_rolled(rtape, *args),
            "plain": lambda: jr.jet_rolled_plain(rtape, *args),
            "b2": lambda: jk.jet(dtape, *args)}
    t = {name: [] for name in runs}
    for name in ("plain", "b2", "b3", "b3", "b2", "plain"):
        t[name].append(cuda_ms(runs[name], 3 if name == "b3" else 1))
    tc_k, _ = runs["b3"]()
    tc_p, _ = runs["plain"]()
    rel_m = float(per_order_rel(tc_k, tc_p).max())
    check(rel_m <= JET_RTOL, f"B3 vs jet_rolled_plain at B={MASCON_B}")
    rolled_err = max(rolled_err, float((tc_k - tc_p).abs().max()))
    # B2 against B3 on narrower tapes: where the rolled jet starts to pay
    sweep = {}
    tapes = {f"mascon{n}": mascon_tapes(mascon_body(n)[0], order, dev)
             for n in SWEEP_N}
    plan = build_plan(ht.taylor_decompose_sys(
        nbody(6, masses=bench.MASSES, Gconst=bench.GCONST)), order)
    ss = ht.plan_to_arrays(plan)
    tapes["outer_ss"] = (jr.RolledTape(ss, dev), jk.JetTape(ss, dev))
    for name, (rt, dtp) in tapes.items():
        if name == "outer_ss":
            st = lanes(bench.IC, MASCON_B, 3)
        else:
            st = mascon_lanes(np.random.default_rng(1), MASCON_B)
        a = jet_args(st)
        b2 = [cuda_ms(lambda: jk.jet(dtp, *a), 1)]
        b3 = [cuda_ms(lambda: jr.jet_rolled(rt, *a), 3) for _ in range(2)]
        b2.append(cuda_ms(lambda: jk.jet(dtp, *a), 1))
        r = float(per_order_rel(jr.jet_rolled(rt, *a)[0],
                                jk.jet(dtp, *a)[0]).max())
        check(r <= JET_RTOL, f"B3 vs B2 on {name}: {r}")
        sweep[name] = dict(W=rt.width, b2_ms=b2, b3_ms=b3,
                           b2_over_b3=(sum(b2) / 2) / (sum(b3) / 2))
    times = dict(ms=sum(t["b3"]) / 2, plain_ms=sum(t["plain"]) / 2)
    say(9, B=MASCON_B, nvidia_smi=smi, b3_ms_runs=t["b3"],
        plain_ms_runs=t["plain"], b2_ms_runs=t["b2"],
        b3_vs_plain_max_rel_per_order=rel_m, sweep=sweep)
    return launches["jet_rolled"], rolled_err, times


def phase_cases(pkg):
    """The tapes of phase 10, built with ``pkg`` (this port; the tests
    also pass the JAX package): name -> (ODE system, state (2,), pars).
    The pendulum, the mixed systems of ``tests/test_compact.py``, two
    for the hyperbolic, division and logical ops, and one per op of
    ``tests/test_pallas_ops.py``; every state is away from the switch
    points of relu, select and the relational ops."""
    m = pkg.math
    x, y = pkg.make_vars("x", "y")
    par, tm = pkg.par, pkg.time_
    cases = {
        "pendulum": (pkg.models.pendulum(), [0.05, 0.025], []),
        "trig": ([(x, m.sin(x) * m.cos(y) + m.tan(0.3 * x)),
                  (y, m.exp(-y) + m.atan2(x, y) + x ** -1.5)],
                 [0.7, 1.3], []),
        "kepE": ([(x, m.kepE(0.3, y)),
                  (y, m.sqrt(x) + m.log(y) + m.erf(x))], [1.2, 0.8], []),
        "kepFDE": ([(x, m.kepF(0.1, 0.2, y)),
                    (y, m.kepDE(0.1, 0.2, x) + m.asin(0.3 * x) + m.tanh(y)
                     + m.sigmoid(x))], [0.9, 0.7], []),
        "select": ([(x, m.select(m.gt(x, 0.0), x * x, -x) + m.relu(y)),
                    (y, m.sigmoid(x) + m.atan(y) + m.acos(0.2 * x)
                     + m.sinh(y))], [0.5, -0.3], []),
        "par_time": ([(x, par[0] * m.sin(tm) + par[1] * x), (y, tm * y)],
                     [0.4, 0.6], [1.1, -0.2]),
        "hyper": ([(x, m.atanh(0.3 * x) + m.asinh(y) / (2.0 + y * y)),
                   (y, m.acosh(1.5 + 0.1 * x * x) - m.cosh(0.2 * y))],
                  [0.4, 0.3], []),
        "logic": ([(x, m.select(m.logical_and(m.lt(x, 2.0), m.ge(y, -3.0)),
                                y, -y) + 0.1 * m.relup(x)),
                   (y, m.select(m.logical_or(m.le(x, -5.0), m.ne(y, 7.0)),
                                -x, x)
                    + 0.01 * m.logical_not(m.eq(x, 5.0)))],
                  [0.5, 0.4], []),
    }
    per_op = {
        "tan": -m.tan(x * 0.3), "tanh": -m.tanh(x),
        "sigmoid": -m.sigmoid(x) + 0.5, "asin": -m.asin(x * 0.5),
        "acos": m.acos(x * 0.5) - np.pi / 2, "atan": -m.atan(x),
        "erf": -m.erf(x), "atan2": -m.atan2(x, 2.0 + y * 0.1),
        "kepE": -m.sin(m.kepE(0.1, x)), "kepF": -m.sin(m.kepF(0.05, 0.05, x)),
        "kepDE": -m.sin(m.kepDE(0.05, 0.3, x)),
    }
    for name, rhs in per_op.items():
        cases[f"op_{name}"] = ([(x, y), (y, rhs)], [0.25, 0.0], [])
    return cases


def phase_lanes(st0, pars, B, seed):
    """``B`` lanes near a case's state: the state plus 0.01 N(0, 1) per
    coordinate, its parameters, times in [0, 2); numpy arrays (B, n),
    (B, n_pars), (B,)."""
    rng = np.random.default_rng(seed)
    st0 = np.asarray(st0, float)
    st = st0[None] + 0.01 * rng.standard_normal((B, st0.size))
    return (st, np.tile(np.asarray(pars, float), (B, 1)).reshape(B, -1),
            rng.uniform(0.0, 2.0, B))


def pendulum_lanes(B, seed):
    """Librating pendulum lanes: x0 = +-U(0.5, 2.0) rad with a random
    sign, v0 = U(-1, 1); energies 1.2 to 14.4, below the separatrix's
    19.6."""
    rng = np.random.default_rng(seed)
    x0 = rng.choice([-1.0, 1.0], B) * rng.uniform(0.5, 2.0, B)
    return np.stack([x0, rng.uniform(-1.0, 1.0, B)], 1)


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
        tc9 = tc_p.clone()
        tc9[PHASE_LO:, :n_w] = float("nan")
        jp.phase(tape, tc9, PHASE_LO)
        torch.cuda.synchronize()
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
        res[name] = dict(W=tape.width, **r)
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
                      propagate_engine="flat", prop=None),
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

    # -- 12. times: B4 against phase_plain ----------------------------------------
    widest = max((n for n in cases if not n.startswith("op_")
                  and n != "pendulum"), key=lambda n: tapes[n].width)
    runs = {}
    for name, B, seed in (("pendulum", PEND_B, 3), (widest, PHASE_B, 4)):
        tape = tapes[name]
        st0, pars = cases[name][1], cases[name][2]
        if name == "pendulum":
            lanes_ = (pendulum_lanes(B, seed), np.zeros((B, 0)),
                      np.zeros(B))
        else:
            lanes_ = phase_lanes(st0, pars, B, seed)
        tc0 = seeded_buffer(tape, *lanes_, dev)
        tck, tcp = tc0.clone(), tc0.clone()
        jargs = lane_tensors(*lanes_, dev)
        t = {"kernel": [], "plain": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            if which == "kernel":
                t[which].append(cuda_ms(lambda: jp.phase(tape, tck, 1), 3))
            else:
                t[which].append(cuda_ms(
                    lambda: jp.phase_plain(tape, tcp, 1), 1))
        r = float(rel(tck, tcp).max())
        check(r <= JET_RTOL, f"B4 vs phase_plain on {name} at B={B}: {r}")
        phase_err = max(phase_err, float((tck - tcp).abs().max()))
        runs[name] = dict(B=B, W=tape.width, ms_runs=t["kernel"],
                          plain_ms_runs=t["plain"], max_rel_per_order=r,
                          jet_phase_ms=cuda_ms(
                              lambda: jp.jet_phase(tape, *jargs), 3))
    say(12, nvidia_smi=smi, **runs)
    tm = runs["pendulum"]
    return launches["phase"], phase_err, dict(
        ms=sum(tm["ms_runs"]) / 2, plain_ms=sum(tm["plain_ms_runs"]) / 2)


if __name__ == "__main__":
    main()
