"""Kernels B1, B2, B3, B4, T1 and T2 of two checkouts of the port on the same
inputs, bit for bit, on one CUDA card.

A redesign that keeps every coefficient's expression (the same terms,
summed in the same order, with no FMA) must give the bits of the build it
replaces.  From the root of a checkout:

    PYTHONPATH=<checkout A> python3 heyoka_tpu_torch/tools/same_bits.py \\
        dump a.pt
    PYTHONPATH=<checkout B> python3 heyoka_tpu_torch/tools/same_bits.py \\
        dump b.pt
    python3 heyoka_tpu_torch/tools/same_bits.py compare a.pt b.pt

``dump`` runs ``jet_kernels.jet`` (B2), ``jet_kernels.prop`` (B1) and
``jet_rolled.jet_rolled`` (B3) of the ``heyoka_tpu_torch`` that
``PYTHONPATH`` names (each checkout builds its own kernels) on inputs made
from fixed seeds, and saves their outputs: the outer-Solar-System tape at
order 19 and 10,240 lanes (one jet, a 64-step chunk with the compensated
update, 16 steps with Horner's), blocks of mixed lanes on the 3-body tape
(inactive, budget, near and non-finite lanes), mascon-32 and mascon-128
jets of B2, B3 jets of mascon-512 and mascon-32 at 1,024 lanes and of a
tape with parameters, a time column, div, sqrt and two exponents, and
mascon-32's slice end to end (``taylor_adaptive_batch`` on the rolled
route: 1,024 bound lanes over two orbits, its final states and times, and
its lane-steps/s).  Then kernel B4 (``jet_phase.phase``) on every tape of
``cases.phase_cases`` at order 19 and 1,024 lanes, from lo = 1 and from
lo = 9, and on 10,240 pendulum lanes; the pendulum slice end to end
(``taylor_adaptive_batch`` on the phase route: 10,240 librating lanes over
10 time units, its final states and times, and its lane-steps/s); and
kernel T2 (``proto_phase.phase_f32``) on the outer-Solar-System tape from
lo = 9 at 10,240 lanes; kernel T1 (``microbench_conv.conv_f32`` and
``conv_dd``) on the tool's inputs at N = 204,800 and at a ragged N =
204,797; with the times (a CUDA graph's replay) of B4 on the pendulum
lanes, of T2 and B4 from lo = 9 on the outer-SS lanes and of both T1
kernels at N = 204,800, the rows of PERF.md's kernel table.  ``compare``
prints one JSON line with, for every output, whether the two dumps are
equal bit for bit (NaN where both are NaN) and their largest difference,
and both dumps' times and lane-steps/s; it exits 1 unless every output is
equal.

    PYTHONPATH=<checkout> python3 heyoka_tpu_torch/tools/same_bits.py \\
        slice <tag>

runs the pendulum slice alone and times kernel B4's wrapper on the host
(:func:`slice_run`), one JSON line: alternate it between two checkouts
to compare their end-to-end rates.

    PYTHONPATH=<checkout> python3 heyoka_tpu_torch/tools/same_bits.py \\
        ss <tag>

runs ``chip_smoke.py`` phase 5's outer-Solar-System slice alone (the
fused route, 10,240 lanes over 100 yr after a 64-lane warm-up), twice on
fresh integrators (:func:`ss_run`), one JSON line: alternate it between
two checkouts to compare the first, cold run and the second.

    PYTHONPATH=<checkout> python3 heyoka_tpu_torch/tools/same_bits.py \\
        t1 <tag>

times kernel T1-dd (``microbench_conv.conv_dd``) on the tool's inputs
(:func:`t1_run`), and its yardstick ``conv_dd_direct`` where the checkout
has one, alternately, one JSON line: alternate it between two checkouts to
compare their T1-dd.

The script imports only torch, numpy, the port's public modules and
``cases.py`` from its own directory (the phase tapes and lanes, loaded by
path, so that both dumps get the same inputs), so it runs against any
checkout since the port's B4 and T2 slices.
"""

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _lanes(ic, B, seed):
    rng = np.random.default_rng(seed)
    return ic[None, :] + np.abs(ic)[None, :] * (
        rng.uniform(-1, 1, (B, ic.size)) * 1e-8)


def _mascon(ht, N):
    rng = np.random.default_rng(42)
    pts = rng.uniform(-1.0, 1.0, (4 * N, 3))
    pts = pts[np.linalg.norm(pts, axis=1) <= 1.0][:N]
    masses = rng.uniform(0.5, 1.0, N)
    return ht.models.mascon(masses=(masses / masses.sum()).tolist(),
                            positions=pts.tolist(),
                            omega=(0.0, 0.0, 2.0 * np.pi / 10.0))


def _par_time(ht):
    # div, sqrt, pow with two exponents in one group, two parameters and
    # the time (tests/test_torch_gpu.py's mixed hand-built system)
    x, y, z = ht.make_vars("x", "y", "z")
    zr = (x * x + z * z + 2.0) ** -1.5 - ht.par[1] * z \
        + 0.01 * (x * x + y * y + 1.0) ** 2.5
    return [(x, ht.par[0] * y / (1.0 + x * x) + ht.sqrt(1.5 + y * y)),
            (y, -x / ht.sqrt(x * x + y * y + 0.3) + 0.1 * ht.time_ * z),
            (z, zr)]


def _orbits(B, seed):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, B)
    r0 = 2.0 + 0.05 * rng.standard_normal(B)
    vc = np.sqrt(1.0 / r0)
    return np.stack([r0 * np.cos(ang), r0 * np.sin(ang), np.zeros(B),
                     -vc * np.sin(ang), vc * np.cos(ang), np.zeros(B)], 1)


def dump(path):
    import heyoka_tpu_torch as ht
    from heyoka_tpu_torch.taylor import jet_kernels as jk
    from heyoka_tpu_torch.taylor.compact import build_plan
    from heyoka_tpu_torch.tools import GCONST, IC, MASSES

    dev = torch.device("cuda")
    f64 = dict(dtype=torch.float64, device=dev)

    def tape(sys_, order):
        return jk.JetTape(ht.plan_to_arrays(build_plan(
            ht.taylor_decompose_sys(sys_), order)), dev)

    def aux(rem, act, B):
        return torch.stack([torch.full((B,), float("inf"), **f64),
                            torch.ones(B, **f64), torch.as_tensor(rem, **f64),
                            torch.zeros(B, **f64), torch.as_tensor(act, **f64)])

    out = {}
    B = 10_240
    ss = tape(ht.models.nbody(6, masses=MASSES, Gconst=GCONST), 19)
    st = torch.as_tensor(_lanes(IC, B, 2).T.copy(), **f64)
    no_pars = torch.zeros((0, B), **f64)
    out["b2_outer_ss"] = jk.jet(ss, st, no_pars)
    a = aux(np.full(B, 1000.0), np.ones(B), B)
    budget = torch.full((1, B), 2**31 - 1, dtype=torch.int32, device=dev)
    out["b1_outer_ss_64_ceval"] = jk.prop(ss, st, no_pars, a, budget, 64,
                                          True)
    out["b1_outer_ss_16_horner"] = jk.prop(ss, st, no_pars, a, budget, 16,
                                           False)

    B = 67
    n3 = tape(ht.models.nbody(3, masses=[1.0, 1e-3, 2e-3]), 12)
    rng = np.random.default_rng(11)
    base = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0,
                     0, 1.5, 0, -0.8, 0, 0], float)
    st_np = base[None] + 0.01 * rng.standard_normal((B, 18))
    st_np[8] = np.nan
    kind = np.arange(B) % 5
    a = aux(np.where(kind == 2, 1.0, 10.0), kind != 0, B)
    budget = torch.as_tensor(np.where(kind == 1, 4, 1000), dtype=torch.int32,
                             device=dev)[None]
    st = torch.as_tensor(st_np.T.copy(), **f64)
    for ha in (True, False):
        out[f"b1_mixed_lanes_{'ceval' if ha else 'horner'}"] = jk.prop(
            n3, st, torch.zeros((0, B), **f64), a, budget, 16, ha)

    B = 1024
    for N in (32, 128):
        st = torch.as_tensor(_orbits(B, N).T.copy(), **f64)
        out[f"b2_mascon{N}"] = jk.jet(tape(_mascon(ht, N), 19), st,
                                      torch.zeros((0, B), **f64))

    from heyoka_tpu_torch.taylor import jet_rolled as jr

    def rtape(sys_):
        return jr.RolledTape(ht.plan_to_arrays(build_plan(
            ht.taylor_decompose_sys(sys_), 19)), dev)

    for N in (512, 32):
        st = torch.as_tensor(_orbits(B, N + 1).T.copy(), **f64)
        out[f"b3_mascon{N}"] = jr.jet_rolled(
            rtape(_mascon(ht, N)), st, torch.zeros((0, B), **f64),
            torch.zeros(B, **f64))
    rng = np.random.default_rng(12)
    out["b3_par_time"] = jr.jet_rolled(
        rtape(_par_time(ht)), torch.as_tensor(rng.uniform(-1, 1, (3, B)),
                                              **f64),
        torch.as_tensor(rng.uniform(0.5, 1.5, (2, B)), **f64),
        torch.as_tensor(rng.uniform(0.0, 2.0, B), **f64))
    timing = {"e2e_mascon32": _slice(ht, out, B)}
    timing["e2e_pendulum"] = _phase(ht, out, dev)
    timing.update(_t1(out, dev))
    torch.cuda.synchronize()
    dumped = {k: [x.cpu() for x in v] for k, v in out.items()}
    torch.save(dict(dumped, _timing=timing), path)
    print(json.dumps({"dumped": path, "cases": list(out), "timing": timing,
                      "device": torch.cuda.get_device_name(0)}))


def _slice(ht, out, B):
    """Mascon-32's slice through ``taylor_adaptive_batch`` on the card: B
    bound lanes (the rotating frame's velocity taken out) over two orbital
    periods after one step, timed after a warm-up; stores the final states
    and times in ``out`` and returns the route and its lane-steps/s."""
    omega = np.array([0.0, 0.0, 2.0 * np.pi / 10.0])
    orbits = _orbits(B, 33)
    orbits[:, 3:] -= np.cross(omega, orbits[:, :3])
    t_end = 4.0 * np.pi * 2.0 ** 1.5
    kw = dict(tol=1e-15, high_accuracy=True, device="cuda")
    sys_ = _mascon(ht, 32)
    ht.taylor_adaptive_batch(sys_, orbits[:8], **kw).propagate_until(1.0)
    ta = ht.taylor_adaptive_batch(sys_, orbits, **kw)
    ta.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nsteps = ta.propagate_until(t_end)[3]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["e2e_mascon32"] = [torch.as_tensor(np.asarray(ta.state)),
                           torch.as_tensor(np.asarray(ta.time))]
    steps = int(np.asarray(nsteps).sum())
    return dict(jet=ta.engine_report()["jet"], wall_s=wall,
                lane_steps=steps, steps_per_s=steps / wall)


def _cases():
    """``cases.py`` beside this script, loaded by its path: the phase tapes
    and lanes, the same whichever checkout ``PYTHONPATH`` names (an older
    one may lack the module)."""
    spec = importlib.util.spec_from_file_location(
        "_same_bits_cases", Path(__file__).with_name("cases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeded(tape, st, pars, t, dev):
    """The ``(K+1, W, B)`` buffer of kernel B4 with order 0 of every
    column and the virtual columns seeded, from numpy lanes."""
    from heyoka_tpu_torch.taylor import jet_kernels as jk
    from heyoka_tpu_torch.taylor import jet_phase as jp

    f = dict(dtype=torch.float64, device=dev)
    tc = jk._seed_plain(tape, torch.as_tensor(st.T.copy(), **f),
                        torch.as_tensor(pars.T.copy(), **f),
                        torch.as_tensor(t, **f))
    jp.order0(tape, tc)
    return tc


def _phase(ht, out, dev):
    """Kernels B4 and T2 into ``out``; returns the pendulum slice's route
    and lane-steps/s."""
    from heyoka_tpu_torch.taylor import jet_phase as jp
    from heyoka_tpu_torch.taylor.compact import build_plan
    from heyoka_tpu_torch.tools import IC, proto_phase as pp

    cs = _cases()

    def tape(sys_):
        return jp.PhaseTape(ht.plan_to_arrays(build_plan(
            ht.taylor_decompose_sys(sys_), 19)), dev)

    for i, (name, (sys_, st0, pars)) in enumerate(
            cs.phase_cases(ht).items()):
        t = tape(sys_)
        tc0 = _seeded(t, *cs.phase_lanes(st0, pars, 1024, 100 + i), dev)
        tc1 = jp.phase(t, tc0.clone(), 1)
        tc9 = tc1.clone()
        tc9[9:, :t.n_eq + t.arrays["arg_ptr"].size - 1] = float("nan")
        out[f"b4_{name}"] = [tc1, jp.phase(t, tc9, 9)]
    B = 10_240
    st = cs.pendulum_lanes(B, 21)
    t = tape(ht.models.pendulum())
    tc = _seeded(t, st, np.zeros((B, 0)), np.zeros(B), dev)
    out["b4_pendulum_10240"] = [jp.phase(t, tc.clone(), 1)]
    timing = {"b4_pendulum_10240_ms": _graph_ms(lambda: jp.phase(t, tc, 1))}
    plan = pp.outer_ss_plan()
    arrays = ht.plan_to_arrays(plan)
    t2, t64 = pp.ProtoTape(arrays, dev), jp.PhaseTape(arrays, dev)
    tc = pp.realistic_buffer(plan, IC, B, 9, dev, 3).permute(
        1, 0, 2).contiguous()
    out["t2_outer_ss_lo9"] = [pp.phase_f32(t2, tc.clone(), 9)]
    tc64 = tc.double()
    timing["t2_outer_ss_lo9_ms"] = _graph_ms(lambda: pp.phase_f32(t2, tc, 9))
    timing["b4_outer_ss_lo9_ms"] = _graph_ms(lambda: jp.phase(t64, tc64, 9))
    res = _pendulum_slice(ht, cs, out)
    return dict(res, **timing)


def _t1(out, dev):
    """Kernel T1 (``microbench_conv.conv_f32`` and ``conv_dd``) into
    ``out`` on the tool's seeded inputs at its N = 204,800 and at a ragged
    N = 204,797 (rows past the first off 16-B alignment); returns both
    kernels' times at N = 204,800 (a CUDA graph's replay)."""
    from heyoka_tpu_torch.tools import microbench_conv as mc

    timing = {}
    for n in (mc.N, mc.N - 3):
        _, _, dd_np = mc.inputs(n, 0)
        dd = [torch.as_tensor(x, device=dev) for x in dd_np]
        a, b = dd[0], dd[2]
        out[f"t1_f32_{n}"] = [mc.conv_f32(a, b)]
        out[f"t1_dd_{n}"] = list(mc.conv_dd(*dd))
        if n == mc.N:
            timing["t1_f32_ms"] = _graph_ms(lambda: mc.conv_f32(a, b), 20)
            timing["t1_dd_ms"] = _graph_ms(lambda: mc.conv_dd(*dd), 20)
    return timing


def _pendulum_slice(ht, cs, out=None):
    """The pendulum slice on the card: 10,240 librating lanes over 10 time
    units through ``taylor_adaptive_batch`` after a warm-up; stores the
    final states and times in ``out`` and returns the route and its
    lane-steps/s."""
    st = cs.pendulum_lanes(10_240, 21)
    kw = dict(tol=1e-15, high_accuracy=True, device="cuda")
    ht.taylor_adaptive_batch(ht.models.pendulum(), st[:8],
                             **kw).propagate_until(1.0)
    ta = ht.taylor_adaptive_batch(ht.models.pendulum(), st, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nsteps = ta.propagate_until(10.0)[3]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if out is not None:
        out["e2e_pendulum"] = [torch.as_tensor(np.asarray(ta.state)),
                               torch.as_tensor(np.asarray(ta.time))]
    steps = int(np.asarray(nsteps).sum())
    return dict(jet=ta.engine_report()["jet"], wall_s=wall,
                lane_steps=steps, steps_per_s=steps / wall)


def slice_run(tag):
    """One run of the pendulum slice (:func:`_pendulum_slice`) and the host
    time of one call of kernel B4's wrapper (``jet_phase.phase`` on 10,240
    pendulum lanes from lo = 1: 500 calls timed on the host's clock before
    the sync, too few to fill the launch queue); prints one JSON line."""
    import heyoka_tpu_torch as ht
    from heyoka_tpu_torch.taylor import jet_phase as jp
    from heyoka_tpu_torch.taylor.compact import build_plan

    dev = torch.device("cuda")
    cs = _cases()
    B = 10_240
    t = jp.PhaseTape(ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(ht.models.pendulum()), 19)), dev)
    tc = _seeded(t, cs.pendulum_lanes(B, 21), np.zeros((B, 0)),
                 np.zeros(B), dev)
    for _ in range(20):
        jp.phase(t, tc, 1)
    torch.cuda.synchronize()
    n = 500
    t0 = time.perf_counter()
    for _ in range(n):
        jp.phase(t, tc, 1)
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    print(json.dumps(dict(tag=tag, wrapper_host_us=host_us,
                          **_pendulum_slice(ht, cs))))


def ss_run(tag, B=10_240):
    """Phase 5's slice: ``taylor_adaptive_batch(nbody(6), ...)`` on
    ``B`` lanes of the outer Solar System perturbed by 1e-8 (seed 0),
    ``propagate_until(100.0)`` after a 64-lane warm-up, then again on a
    fresh integrator; prints the lane-steps/s of both runs, the seconds
    each spent in the propagation driver (``_pu_fn``, closed by a device
    sync), the device memory the allocator held before and after each,
    and a checksum of the final states (equal between checkouts that keep
    the bits)."""
    import heyoka_tpu_torch as ht
    from heyoka_tpu_torch.tools import GCONST, IC, MASSES

    sys_ = ht.models.nbody(6, masses=MASSES, Gconst=GCONST)
    ics = _lanes(IC, B, 0)
    kw = dict(tol=1e-15, high_accuracy=True, device="cuda")
    ht.taylor_adaptive_batch(sys_, ics[:64], **kw).propagate_until(1.0)
    rates, driver_s, reserved = [], [], []
    for _ in range(2):
        ta = ht.taylor_adaptive_batch(sys_, ics, **kw)
        pu = ta._pu_fn

        def timed_pu(*args):
            t1 = time.perf_counter()
            res = pu(*args)
            torch.cuda.synchronize()
            driver_s.append(time.perf_counter() - t1)
            return res

        ta._pu_fn = timed_pu
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
        t0 = time.perf_counter()
        nsteps = ta.propagate_until(100.0)[3]
        torch.cuda.synchronize()
        rates.append(int(np.asarray(nsteps).sum())
                     / (time.perf_counter() - t0))
        reserved.append(torch.cuda.memory_reserved())
    print(json.dumps(dict(tag=tag, steps_per_s=rates, driver_s=driver_s,
                          reserved_bytes=reserved,
                          state_sum=float(np.abs(ta.state).sum()))))


def t1_run(tag, readings=5):
    """``readings`` times (each a CUDA graph's replay of 20 calls) of
    kernel T1-dd at the tool's N = 204,800, seed 0, alternating with its
    yardstick ``microbench_conv.conv_dd_direct`` where the checkout has
    it; prints one JSON line."""
    from heyoka_tpu_torch.tools import microbench_conv as mc

    dev = torch.device("cuda")
    dd = [torch.as_tensor(x, device=dev) for x in mc.inputs(mc.N, 0)[2]]
    fns = {"t1_dd_ms": lambda: mc.conv_dd(*dd)}
    if hasattr(mc, "conv_dd_direct"):
        fns["t1_dd_direct_ms"] = lambda: mc.conv_dd_direct(*dd)
    got = {k: [] for k in fns}
    for _ in range(readings):
        for k, fn in fns.items():
            got[k].append(_graph_ms(fn, 20))
    print(json.dumps(dict(tag=tag, **got)))


def _graph_ms(fn, reps=10):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs replayed
    from one CUDA graph (``heyoka_tpu_torch.tools.graph_ms``, which older
    checkouts lack)."""
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


def _same(a, b):
    if a.dtype.is_floating_point:
        nan = torch.isnan(a) & torch.isnan(b)
        a, b = torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)
        bits = torch.int64 if a.element_size() == 8 else torch.int32
        same = bool((a.view(bits) == b.view(bits)).all())
        diff = torch.where(a == b, 0.0, (a - b).abs())  # inf == inf
        return same, float(diff.max()) if a.numel() else 0.0
    return bool(torch.equal(a, b)), float((a - b).abs().max())


def compare(pa, pb):
    da, db = torch.load(pa), torch.load(pb)
    ta, tb = da.pop("_timing"), db.pop("_timing")
    res = {}
    for case in da:
        res[case] = [dict(zip(("equal", "max_abs_diff"), _same(x, y)))
                     for x, y in zip(da[case], db[case])]
    ok = set(da) == set(db) and all(
        r["equal"] for rs in res.values() for r in rs)
    print(json.dumps({"same_bits": ok, "cases": res,
                      "timing": {k: [ta[k], tb[k]] for k in ta}}))
    return ok


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "dump":
        if not torch.cuda.is_available():
            raise SystemExit("same_bits: no CUDA device")
        dump(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "slice":
        if not torch.cuda.is_available():
            raise SystemExit("same_bits: no CUDA device")
        slice_run(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "ss":
        if not torch.cuda.is_available():
            raise SystemExit("same_bits: no CUDA device")
        ss_run(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "t1":
        if not torch.cuda.is_available():
            raise SystemExit("same_bits: no CUDA device")
        t1_run(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(0 if compare(sys.argv[2], sys.argv[3]) else 1)
    else:
        raise SystemExit(__doc__)
