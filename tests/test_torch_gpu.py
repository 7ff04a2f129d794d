"""The port's CUDA kernels against their plain torch twins, on a CUDA
device.  This file imports neither JAX nor the JAX package, so it runs
where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Without a CUDA device every test skips.  ``chip_smoke.py`` makes the same
comparisons at the main path's shapes."""

import numpy as np
import pytest
import torch

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.expr.decompose import taylor_decompose_sys
from heyoka_tpu_torch.taylor import batch as tbatch
from heyoka_tpu_torch.taylor import jet_kernels as jk
from heyoka_tpu_torch.taylor import jet_phase as jp
from heyoka_tpu_torch.taylor import jet_rolled as jr
from heyoka_tpu_torch.taylor.compact import build_plan
from heyoka_tpu_torch.tools import mascon_body
from heyoka_tpu_torch.tools import microbench_conv as mc
from heyoka_tpu_torch.tools import proto_phase as pp

from chip_smoke import pendulum_lanes, phase_cases, phase_lanes, seeded_buffer

MASSES = [1.0, 1e-3, 2e-3]
BASE = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0,
                 0, 1.5, 0, -0.8, 0, 0], float)


def _nbody3():
    return ht.models.nbody(3, masses=MASSES)


def _handbuilt(mixed=False):
    # div, sqrt, pow, two parameters and the time; ``mixed`` adds a second
    # exponent at the level of the ** -1.5 (one pow group holding both)
    x, y, z = ht.make_vars("x", "y", "z")
    zr = (x * x + z * z + 2.0) ** -1.5 - ht.par[1] * z
    if mixed:
        zr = zr + 0.01 * (x * x + y * y + 1.0) ** 2.5
    return [
        (x, ht.par[0] * y / (1.0 + x * x) + ht.sqrt(1.5 + y * y)),
        (y, -x / ht.sqrt(x * x + y * y + 0.3) + 0.1 * ht.time_ * z),
        (z, zr),
    ]


def _mascon12():
    # tests/test_pallas_rolled.py's body: 12 mascons in the unit ball
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1.0, 1.0, (48, 3))
    pts = pts[np.linalg.norm(pts, axis=1) <= 1.0][:12]
    masses = rng.uniform(0.5, 1.0, 12)
    return ht.models.mascon(masses=(masses / masses.sum()).tolist(),
                            positions=pts.tolist(), omega=(0.0, 0.0, 0.3))


SYSTEMS = {"nbody3": _nbody3, "handbuilt": _handbuilt, "mascon12": _mascon12,
           "handbuilt_mixed": lambda: _handbuilt(mixed=True),
           "mascon32": lambda: ht.models.mascon(**mascon_body(32)[0]),
           "mascon128": lambda: ht.models.mascon(**mascon_body(128)[0]),
           "mascon512": lambda: ht.models.mascon(**mascon_body(512)[0])}


def _orbits(B, seed):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, B)
    return np.stack([2 * np.cos(ang), 2 * np.sin(ang), np.zeros(B),
                     -0.7 * np.sin(ang), 0.7 * np.cos(ang), np.zeros(B)], 1)


def _inputs(name, B, seed):
    rng = np.random.default_rng(seed)
    if name == "nbody3":
        return (BASE[None] + 0.01 * rng.standard_normal((B, 18)),
                np.zeros((B, 0)), np.zeros(B))
    if name.startswith("mascon"):
        return _orbits(B, seed), np.zeros((B, 0)), np.zeros(B)
    return (rng.uniform(-1.0, 1.0, (B, 3)), rng.uniform(0.5, 1.5, (B, 2)),
            rng.uniform(0.0, 2.0, B))


def _tape(name, order, device, cls=jk.JetTape):
    plan = build_plan(taylor_decompose_sys(SYSTEMS[name]()), order)
    return cls(ht.plan_to_arrays(plan), device)


def _per_order_rel(a, b):
    scale = b.abs().amax(dim=(0, 2))
    return (a - b).abs().amax(dim=(0, 2)) / torch.where(
        scale > 0, scale, torch.ones_like(scale))


def _dev(a, device):
    return torch.as_tensor(np.ascontiguousarray(a, np.float64), device=device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nbody3", "handbuilt", "mascon12"])
def test_jet_kernel_matches_plain(cuda, name):
    # 1e-13 relative per order: f64 in both, only the summation order of
    # the convolutions differs
    B, K = 200, 15
    tape = _tape(name, K, cuda)
    st, pars, t = _inputs(name, B, 3)
    args = (_dev(st.T, cuda), _dev(pars.T, cuda), _dev(t, cuda))
    n0 = jk.LAUNCHES["jet"]
    tc, norms = jk.jet(tape, *args)
    torch.cuda.synchronize()
    assert jk.LAUNCHES["jet"] == n0 + 1
    tc_p, norms_p = jk.jet_plain(tape, *args)
    assert float(_per_order_rel(tc, tc_p).max()) <= 1e-13
    # the norms to the same bound, relative to each row's max over lanes
    nrel = (norms - norms_p).abs().amax(1) / norms_p.amax(1)
    assert float(nrel.max()) <= 1e-13


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mascon12", "handbuilt", "handbuilt_mixed"])
def test_jet_rolled_kernel_matches_plain_and_b2(cuda, name):
    # kernel B3 against its twin (1e-13 relative per order: f64 in both,
    # the summation order differs) and against kernel B2 on the same
    # inputs (the same recurrences in the same order)
    B, K = 200, 15
    tape = _tape(name, K, cuda, jr.RolledTape)
    st, pars, t = _inputs(name, B, 5)
    args = (_dev(st.T, cuda), _dev(pars.T, cuda), _dev(t, cuda))
    n0 = dict(jk.LAUNCHES)
    tc, norms = jr.jet_rolled(tape, *args)
    torch.cuda.synchronize()
    assert jk.LAUNCHES["jet_rolled"] == n0["jet_rolled"] + 1
    tc_p, norms_p = jr.jet_rolled_plain(tape, *args)
    tc_2, norms_2 = jk.jet(tape, *args)
    torch.cuda.synchronize()
    for ref_tc, ref_n in ((tc_p, norms_p), (tc_2, norms_2)):
        assert float(_per_order_rel(tc, ref_tc).max()) <= 1e-13
        nrel = (norms - ref_n).abs().amax(1) / ref_n.amax(1)
        assert float(nrel.max()) <= 1e-13


def _rolled_vs_twin_and_b2(cuda, tape, args, **kw):
    """Kernel B3 (``jr._jet_rolled_cuda`` with ``kw``) against its twin and
    kernel B2 on the same inputs: 1e-13 relative per order, the norms to
    the same bound.  Returns B3's outputs."""
    n0 = jk.LAUNCHES["jet_rolled"]
    tc, norms = jr._jet_rolled_cuda(tape, *args, **kw)
    torch.cuda.synchronize()
    assert jk.LAUNCHES["jet_rolled"] == n0 + 1
    assert bool(torch.isfinite(tc).all())
    for ref_tc, ref_n in (jr.jet_rolled_plain(tape, *args),
                          jk.jet(tape, *args)):
        assert float(_per_order_rel(tc, ref_tc).max()) <= 1e-13
        nrel = (norms - ref_n).abs().amax(1) / ref_n.amax(1)
        assert float(nrel.max()) <= 1e-13
    return tc, norms


@pytest.mark.gpu
@pytest.mark.parametrize("threads", jr.BLOCK_THREADS)
@pytest.mark.parametrize("layout", ["smem", "global"])
@pytest.mark.parametrize("name", ["mascon32", "handbuilt_mixed"])
def test_jet_rolled_layouts_and_block_sizes(cuda, name, layout, threads):
    # B3 on both layouts (the global one forced on a tape whose lane fits
    # shared memory) at every block size, order 19, B not a multiple of
    # the blocks a global launch takes; every shape computes each item
    # alike, so all equal the default launch bit for bit
    B, K = 301, 19
    tape = _tape(name, K, cuda, jr.RolledTape)
    assert jr.block_layout(tape)[0] == "smem"
    st, pars, t = _inputs(name, B, 12)
    args = (_dev(st.T, cuda), _dev(pars.T, cuda), _dev(t, cuda))
    got = _rolled_vs_twin_and_b2(cuda, tape, args, threads=threads,
                                 layout=layout)
    ref = jr.jet_rolled(tape, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["smem", "global"])
def test_jet_rolled_mascon512(cuda, layout):
    # the slice's tape: 3,072 aliases, 214,488 B a lane, which fits a
    # block's shared memory but one block an SM: the global layout
    B, K = 24, 19
    tape = _tape("mascon512", K, cuda, jr.RolledTape)
    assert jr.block_layout(tape) == ("global", 214_488)
    args = (_dev(_orbits(B, 13).T, cuda),
            torch.zeros((0, B), dtype=torch.float64, device=cuda),
            torch.zeros(B, dtype=torch.float64, device=cuda))
    _rolled_vs_twin_and_b2(cuda, tape, args, layout=layout)


@pytest.mark.gpu
def test_jet_rolled_rejects_bad_inputs(cuda):
    tape = _tape("mascon12", 8, cuda, jr.RolledTape)
    st = _dev(_inputs("mascon12", 4, 0)[0].T, cuda)
    pars = torch.zeros(0, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        jr.jet_rolled(tape, st.float(), pars)
    with pytest.raises(ValueError):
        jr.jet_rolled(tape, st.cpu(), pars)  # tables on the card
    with pytest.raises(ValueError):
        jr._jet_rolled_cuda(tape, st, pars, threads=512)


@pytest.mark.gpu
def test_rolled_slice_on_cuda_matches_cpu(cuda, monkeypatch):
    # mascon-12 routed to the rolled jet: kernel B3 runs every step
    monkeypatch.setattr(tbatch, "ROLLED_MIN_WIDTH", 64)
    st = _orbits(6, 8)
    kw = dict(tol=1e-12, high_accuracy=True)
    c = ht.taylor_adaptive_batch(_mascon12(), st, device="cpu", **kw)
    g = ht.taylor_adaptive_batch(_mascon12(), st, device=cuda, **kw)
    assert g.engine_report()["jet"] == "hy_jet_rolled_f64"
    n0 = dict(jk.LAUNCHES)
    rc = c.propagate_until(5.0)
    rg = g.propagate_until(5.0)
    assert jk.LAUNCHES["jet_rolled"] > n0["jet_rolled"]
    assert jk.LAUNCHES["jet"] == n0["jet"]
    assert jk.LAUNCHES["prop"] == n0["prop"]
    assert rg[0] == rc[0] and (g.time == 5.0).all()
    np.testing.assert_allclose(g.state, c.state, rtol=0, atol=1e-11)


@pytest.mark.gpu
@pytest.mark.parametrize("high_accuracy", [True, False])
def test_prop_kernel_matches_plain(cuda, high_accuracy):
    B = 64
    tape = _tape("nbody3", 12, cuda)
    st = _dev(_inputs("nbody3", B, 7)[0].T, cuda)
    pars = torch.zeros(0, B, dtype=torch.float64, device=cuda)
    rem = np.where(np.arange(B) % 4 == 0, 1.5, 10.0)  # some lanes near
    aux = torch.stack([_dev(np.full(B, np.inf), cuda),
                       _dev(np.ones(B), cuda), _dev(rem, cuda),
                       _dev(np.zeros(B), cuda),
                       _dev(np.arange(B) % 8 != 5, cuda)])
    budget = torch.as_tensor(np.where(np.arange(B) % 8 == 3, 4, 1000),
                             dtype=torch.int32, device=cuda)[None]
    n0 = jk.LAUNCHES["prop"]
    k = jk.prop(tape, st, pars, aux, budget, 16, high_accuracy)
    torch.cuda.synchronize()
    assert jk.LAUNCHES["prop"] == n0 + 1
    p = jk.prop_plain(tape, st, pars, aux, budget, 16, high_accuracy)
    assert torch.equal(k[2], p[2])  # n_taken, near, err per lane
    torch.testing.assert_close(k[0], p[0], rtol=0, atol=1e-11)
    # acc_hi, min_h, max_h, last_h (acc_lo is a rounding residue)
    rows = [0, 2, 3, 4]
    torch.testing.assert_close(k[1][rows], p[1][rows], rtol=1e-11, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("high_accuracy", [True, False])
def test_prop_kernel_mixed_lanes(cuda, lanes, high_accuracy):
    # blocks of mixed lanes, B not a multiple of the lanes a block: lanes
    # inactive from the start, lanes with a budget of 4, lanes near their
    # target after a few steps, a non-finite lane (err at its first step)
    # and free lanes; flags equal, the state within 1e-11
    B = 67
    tape = _tape("nbody3", 12, cuda)
    st_np = _inputs("nbody3", B, 11)[0]
    st_np[8] = np.nan
    st = _dev(st_np.T, cuda)
    pars = torch.zeros(0, B, dtype=torch.float64, device=cuda)
    kind = np.arange(B) % 5
    rem = np.where(kind == 2, 1.0, 10.0)
    aux = torch.stack([_dev(np.full(B, np.inf), cuda), _dev(np.ones(B), cuda),
                       _dev(rem, cuda), _dev(np.zeros(B), cuda),
                       _dev(kind != 0, cuda)])
    budget = torch.as_tensor(np.where(kind == 1, 4, 1000), dtype=torch.int32,
                             device=cuda)[None]
    n0 = jk.LAUNCHES["prop"]
    k = jk._prop_cuda(tape, st, pars, aux, budget, 16, high_accuracy,
                      lanes=lanes, threads=128)
    torch.cuda.synchronize()
    assert jk.LAUNCHES["prop"] == n0 + 1
    p = jk.prop_plain(tape, st, pars, aux, budget, 16, high_accuracy)
    assert torch.equal(k[2], p[2])
    oi = p[2].cpu().numpy()
    assert oi[2, 8] == 1 and oi[0, 8] == 0  # the non-finite lane
    assert (oi[0, kind == 0] == 0).all() and (oi[0, kind == 1] == 4).all()
    assert oi[1, kind == 2].all() and (oi[0, kind == 2] > 0).all()
    torch.testing.assert_close(k[0], p[0], rtol=0, atol=1e-11,
                               equal_nan=True)
    rows = [0, 2, 3, 4]
    torch.testing.assert_close(k[1][rows], p[1][rows], rtol=1e-11, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name,layout,threads,tables", [
    ("nbody3", "smem", None, "smem"),
    ("nbody3", "smem", 128, "global"),  # the tables would cost a block
    ("mascon32", "smem", None, "smem"),
    ("mascon128", "global", None, "global")])
def test_jet_kernel_layouts(cuda, name, layout, threads, tables):
    # B2 against jet_plain at order 19 with the jets in shared memory and,
    # where one lane's jet does not fit (mascon-128: 2,325 columns, 372 KB
    # a lane), in the global scratch buffer; the tables in shared memory
    # or not: 1e-13 relative per order
    B, K = 37, 19
    tape = _tape(name, K, cuda)
    assert jk.layout_report(tape)["layout"] == layout
    st, pars, t = _inputs(name, B, 9)
    args = (_dev(st.T, cuda), _dev(pars.T, cuda), _dev(t, cuda))
    cfg = jk._launch_cfg(tape, B, cuda, None, threads)
    assert (cfg[4] > 0) == (tables == "smem")
    tc, norms = jk._jet_cuda(tape, *args, None, threads)
    torch.cuda.synchronize()
    tc_p, norms_p = jk.jet_plain(tape, *args)
    assert float(_per_order_rel(tc, tc_p).max()) <= 1e-13
    nrel = (norms - norms_p).abs().amax(1) / norms_p.amax(1)
    assert float(nrel.max()) <= 1e-13


@pytest.mark.gpu
def test_prop_kernel_global_layout(cuda):
    # B1 on the global layout against prop_plain: mascon-128 at order 19
    B = 9
    tape = _tape("mascon128", 19, cuda)
    assert jk.layout_report(tape)["layout"] == "global"
    st = _dev(_inputs("mascon128", B, 10)[0].T, cuda)
    pars = torch.zeros(0, B, dtype=torch.float64, device=cuda)
    aux = torch.stack([_dev(np.full(B, np.inf), cuda), _dev(np.ones(B), cuda),
                       _dev(np.full(B, 100.0), cuda),
                       _dev(np.zeros(B), cuda), _dev(np.ones(B), cuda)])
    budget = torch.full((1, B), 1000, dtype=torch.int32, device=cuda)
    k = jk.prop(tape, st, pars, aux, budget, 3, True)
    torch.cuda.synchronize()
    p = jk.prop_plain(tape, st, pars, aux, budget, 3, True)
    assert torch.equal(k[2], p[2]) and bool((p[2][0] == 3).all())
    torch.testing.assert_close(k[0], p[0], rtol=0, atol=1e-11)


@pytest.mark.gpu
def test_smem_layout_allocates_no_jet_scratch(cuda):
    # with the jets in shared memory neither wrapper allocates the (K+1,
    # W, B) buffer: the peak over one launch stays within its outputs
    B, K = 2048, 19
    tape = jk.JetTape(ht.plan_to_arrays(build_plan(taylor_decompose_sys(
        ht.models.nbody(6)), K)), cuda)
    assert jk.layout_report(tape)["layout"] == "smem"
    scratch = (K + 1) * tape.width * B * 8
    st = _dev(np.tile(np.linspace(1.0, 2.0, 36)[:, None], (1, B)), cuda)
    pars = torch.zeros(0, B, dtype=torch.float64, device=cuda)
    aux = torch.stack([_dev(np.full(B, np.inf), cuda), _dev(np.ones(B), cuda),
                       _dev(np.full(B, 1e3), cuda), _dev(np.zeros(B), cuda),
                       _dev(np.ones(B), cuda)])
    budget = torch.full((1, B), 1000, dtype=torch.int32, device=cuda)
    for run, out_bytes in (
            (lambda: jk.jet(tape, st, pars), (36 * (K + 1) + 3) * B * 8),
            (lambda: jk.prop(tape, st, pars, aux, budget, 2),
             (36 + 5) * B * 8 + 3 * B * 4)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        assert peak <= out_bytes + (1 << 20) < scratch // 8
        del res


@pytest.mark.gpu
def test_wrappers_reject_bad_inputs(cuda):
    tape = _tape("nbody3", 8, cuda)
    st = _dev(_inputs("nbody3", 4, 0)[0].T, cuda)
    pars = torch.zeros(0, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        jk.jet(tape, st.float(), pars)
    with pytest.raises(ValueError):
        jk.jet(tape, st.T.contiguous().T, pars)  # not contiguous
    with pytest.raises(ValueError):
        jk.jet(tape, st[:, :3].contiguous(), pars)  # lane counts differ


@pytest.mark.gpu
def test_slice_on_cuda_matches_cpu(cuda):
    st = _inputs("nbody3", 6, 4)[0]
    kw = dict(tol=1e-12, high_accuracy=True)
    c = ht.taylor_adaptive_batch(_nbody3(), st, device="cpu", **kw)
    g = ht.taylor_adaptive_batch(_nbody3(), st, device=cuda, **kw)
    n0 = dict(jk.LAUNCHES)
    rc = c.propagate_until(5.0)
    rg = g.propagate_until(5.0)
    assert jk.LAUNCHES["prop"] > n0["prop"]
    assert jk.LAUNCHES["jet"] > n0["jet"]
    assert rg[0] == rc[0] and (g.time == 5.0).all()
    np.testing.assert_allclose(g.state, c.state, rtol=0, atol=1e-11)
    assert g.engine_report()["prop"] == "hy_prop_f64"
    g.step()
    c.step()
    np.testing.assert_allclose(g.state, c.state, rtol=0, atol=1e-11)


PHASE_CASES = phase_cases(ht)


def _phase_tape(name, order, device):
    plan = build_plan(taylor_decompose_sys(PHASE_CASES[name][0]), order)
    return jp.PhaseTape(ht.plan_to_arrays(plan), device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(PHASE_CASES))
def test_phase_kernel_matches_plain(cuda, name):
    # kernel B4 against its twin from lo = 1 and from lo = 9 (the lower
    # orders from the twin, the rest NaN): 1e-13 relative per order, f64
    # in both, only the summation order inside the convolutions differs
    B, K = 200, 15
    tape = _phase_tape(name, K, cuda)
    st0, pars = PHASE_CASES[name][1:]
    tc0 = seeded_buffer(tape, *phase_lanes(st0, pars, B, 5), cuda)
    n0 = jk.LAUNCHES["phase"]
    tc_k = jp.phase(tape, tc0.clone(), 1)
    torch.cuda.synchronize()
    assert jk.LAUNCHES["phase"] == n0 + 1
    tc_p = jp.phase_plain(tape, tc0.clone(), 1)
    tc9 = tc_p.clone()
    tc9[9:, :tape.n_eq + tape.arrays["arg_ptr"].size - 1] = float("nan")
    jp.phase(tape, tc9, 9)
    torch.cuda.synchronize()
    for tc in (tc_k, tc9):
        assert bool(torch.isfinite(tc).all())
        rel = _per_order_rel(tc.permute(1, 0, 2), tc_p.permute(1, 0, 2))
        assert float(rel.max()) <= 1e-13


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pendulum", "kepFDE", "hyper"])
def test_phase_kernel_every_shape_equals_the_default(cuda, name):
    # kernel B4 at every block shape and layout it takes, forced, from
    # lo = 1 and lo = 9, on a lane count that no shape divides: each item
    # keeps its expression and term order, so the bits do not move
    B, K = 203, 15
    tape = _phase_tape(name, K, cuda)
    st0, pars = PHASE_CASES[name][1:]
    tc0 = seeded_buffer(tape, *phase_lanes(st0, pars, B, 7), cuda)
    ref = jp.phase(tape, tc0.clone(), 1)
    tc9 = ref.clone()
    tc9[9:, :int(tape.lvl[-1])] = float("nan")
    for lay, L, nt in jp.sweep_shapes(tape, 8):
        for lo, src in ((1, tc0), (9, tc9)):
            got = jp._phase_cuda(tape, src.clone(), lo, L, nt, lay)
            assert torch.equal(got, ref), (lay, L, nt, lo)


@pytest.mark.gpu
def test_proto_phase_every_shape_equals_the_default(cuda):
    # kernel T2 likewise, on the outer-SS tape at order 12 from lo = 5
    plan, lo = pp.outer_ss_plan(12), 5
    tape = pp.ProtoTape(ht.plan_to_arrays(plan), cuda)
    tc = pp.realistic_buffer(plan, pp.IC, 37, lo, cuda).permute(
        1, 0, 2).contiguous()
    ref = pp.phase_f32(tape, tc.clone(), lo)
    for lay, L, nt in jp.sweep_shapes(tape, 4, pp.SWEEP_LANES):
        got = pp._phase_f32_cuda(tape, tc.clone(), lo, L, nt, lay)
        assert torch.equal(got, ref), (lay, L, nt)


@pytest.mark.gpu
def test_phase_stage_keeps_the_rows_it_does_not_write(cuda):
    # the staging alone copies the rows in and back: orders below lo and
    # the virtual columns come back as they were, not counted as a launch;
    # a tape on the global layout stages nothing and is refused
    B, K, lo = 203, 15, 5
    tape = _phase_tape("par_time", K, cuda)
    st0, pars = PHASE_CASES["par_time"][1:]
    tc = jp.phase(tape, seeded_buffer(tape, *phase_lanes(st0, pars, B, 3),
                                      cuda), 1)
    ref, n0 = tc.clone(), jk.LAUNCHES["phase"]
    assert jp.block_shape(tape, B, 8).layout == "smem"
    jp.stage(tape, tc, lo)
    torch.cuda.synchronize()
    n_w = int(tape.lvl[-1])
    assert torch.equal(tc[:lo], ref[:lo])
    assert torch.equal(tc[:, n_w:], ref[:, n_w:])
    assert jk.LAUNCHES["phase"] == n0
    ss = jp.PhaseTape(ht.plan_to_arrays(pp.outer_ss_plan(19)), cuda)
    with pytest.raises(ValueError):
        jp.stage(ss, torch.zeros((20, ss.width, B), dtype=torch.float64,
                                 device=cuda), lo)


@pytest.mark.gpu
def test_phase_rejects_bad_inputs(cuda):
    tape = _phase_tape("pendulum", 8, cuda)
    tc = seeded_buffer(tape, pendulum_lanes(4, 0), np.zeros((4, 0)),
                       np.zeros(4), cuda)
    with pytest.raises(ValueError):
        jp.phase(tape, tc.float(), 1)  # dtype
    with pytest.raises(ValueError):
        jp.phase(tape, tc[:, :-1].contiguous(), 1)  # shape
    with pytest.raises(ValueError):
        jp.phase(tape, tc.cpu(), 1)  # the tables live on the card
    with pytest.raises(ValueError):
        jp.phase(tape, tc.transpose(1, 2).contiguous().transpose(1, 2), 1)
    with pytest.raises(ValueError):
        jp.phase(tape, tc, 0)  # order 0 is not the kernel's


@pytest.mark.gpu
def test_pendulum_slice_on_cuda_matches_cpu(cuda):
    st = pendulum_lanes(8, 6)
    kw = dict(tol=1e-15, high_accuracy=True)
    c = ht.taylor_adaptive_batch(ht.models.pendulum(), st, device="cpu", **kw)
    g = ht.taylor_adaptive_batch(ht.models.pendulum(), st, device=cuda, **kw)
    assert g.engine_report()["jet"] == "hy_phase_f64"
    n0 = dict(jk.LAUNCHES)
    rc = c.propagate_until(5.0)
    rg = g.propagate_until(5.0)
    assert jk.LAUNCHES["phase"] > n0["phase"]
    assert all(jk.LAUNCHES[k] == n0[k] for k in ("jet", "prop",
                                                  "jet_rolled"))
    assert rg[0] == rc[0] and (g.time == 5.0).all()
    np.testing.assert_allclose(g.state, c.state, rtol=0, atol=1e-11)
    g.step()
    c.step()
    np.testing.assert_allclose(g.state, c.state, rtol=0, atol=1e-11)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [300, mc.N])  # a ragged block; the tool's N
def test_conv_kernels_match_plain(cuda, n):
    # kernel T1 against its plain versions: f32 to 1e-6 and two-f32 hi + lo
    # to 1e-12, relative to max(1, |c|); the same arithmetic in the same
    # order without FMA in both
    a64, b64, dd_np = mc.inputs(n, seed=1)
    a, b = (torch.as_tensor(x, device=cuda).float() for x in (a64, b64))
    dd = tuple(torch.as_tensor(x, device=cuda) for x in dd_np)
    n0 = dict(jk.LAUNCHES)
    c = mc.conv_f32(a, b)
    hi, lo = mc.conv_dd(*dd)
    torch.cuda.synchronize()
    assert jk.LAUNCHES["conv_f32"] == n0["conv_f32"] + 1
    assert jk.LAUNCHES["conv_dd"] == n0["conv_dd"] + 1
    assert mc.rel_err(c, mc.conv_f32_plain(a, b)) <= mc.F32_RTOL
    phi, plo = mc.conv_dd_plain(*dd)
    assert mc.rel_err(hi.double() + lo.double(),
                      phi.double() + plo.double()) <= mc.DD_RTOL
    c64 = mc.conv_f64(*(torch.as_tensor(x, device=cuda) for x in (a64, b64)))
    assert mc.rel_err(hi.double() + lo.double(), c64) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 300, mc.N - 3, mc.N])
def test_conv_dd_ring_tiles_match_plain(cuda, n):
    # kernel T1-dd and its yardstick at every forced tile, bit for bit
    # equal to conv_dd_plain: the same terms in the same order without FMA;
    # N = 1 and 300 fit one block, N - 3 takes the 4-B copies (rows off
    # 16-B alignment), N the bulk ones
    dd = [torch.as_tensor(x, device=cuda) for x in mc.inputs(n, seed=5)[2]]
    phi, plo = mc.conv_dd_plain(*dd)
    for T in mc.TILES:
        for fn in (mc._conv_dd_cuda, mc.conv_dd_direct):
            hi, lo = fn(*dd, T)
            assert torch.equal(hi, phi) and torch.equal(lo, plo), (T, fn)


@pytest.mark.gpu
def test_conv_dd_ring_off_16_bytes(cuda):
    # inputs 4 B past a 16-B boundary at the tool's N: the 4-B copies
    dd = []
    for x in mc.inputs(mc.N, seed=6)[2]:
        buf = torch.empty(x.size + 1, device=cuda)
        t = buf[1:].view(x.shape)
        t.copy_(torch.as_tensor(x))
        dd.append(t)
    assert dd[0].data_ptr() % 16 == 4
    hi, lo = mc.conv_dd(*dd)
    phi, plo = mc.conv_dd_plain(*dd)
    assert torch.equal(hi, phi) and torch.equal(lo, plo)


@pytest.mark.gpu
def test_conv_dd_ring_trace(cuda):
    # the trace instance leaves the bits alone and its clock readings come
    # in order: before the wait, data in, lane read, arithmetic done, for
    # each tile a block took (two tiles a block here, zeros after)
    n = 4 * 132 * 128
    dd = [torch.as_tensor(x, device=cuda) for x in mc.inputs(n, seed=7)[2]]
    sh = mc.conv_shape(n, 128)
    tr = torch.zeros((sh.blocks, mc.TRACE_TILES, 4), dtype=torch.int64,
                     device=cuda)
    hi, lo = mc._conv_dd_cuda(*dd, 128, trace=tr)
    phi, plo = mc.conv_dd_plain(*dd)
    assert torch.equal(hi, phi) and torch.equal(lo, plo)
    own = torch.full((sh.blocks,), n // 128 // sh.blocks)
    own[:n // 128 - int(own.sum())] += 1
    for b in range(sh.blocks):
        t = tr[b].cpu()
        assert (t[:own[b]] > 0).all() and (t[own[b]:] == 0).all()
        assert (t[:own[b]].flatten().diff() >= 0).all()
    summary = mc.trace(cuda)
    assert len(summary["arithmetic_us"]) == mc.TRACE_TILES


@pytest.mark.gpu
def test_conv_rejects_bad_inputs(cuda):
    a = torch.ones((mc.K, 64), device=cuda)
    with pytest.raises(ValueError):
        mc.conv_f32(a.double(), a.double())  # dtype
    with pytest.raises(ValueError):
        mc.conv_f32(a[:8].contiguous(), a[:8].contiguous())  # K
    with pytest.raises(ValueError):
        mc.conv_f32(a, a[:, :32].contiguous())  # shapes differ
    with pytest.raises(ValueError):
        mc.conv_dd(a, a, a, a.t().contiguous().t())  # not contiguous


def _mixed_pow():
    # sum, mul and one pow group holding the exponents -1.5 and 2.5
    x, y = ht.make_vars("x", "y")
    return [(x, y * (x * x + y * y + 2.0) ** -1.5),
            (y, -x + 0.01 * (x * x + y * y + 1.0) ** 2.5)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["outer_ss_small", "outer_ss", "mixed"])
def test_proto_phase_kernel_matches_plain(cuda, case):
    # kernel T2 against its plain body: per order within 1e-5 of the
    # order's largest magnitude (f32 over sums of up to 20 terms; the same
    # order without FMA in both)
    if case == "mixed":
        plan, ic, n_lanes, lo = (build_plan(taylor_decompose_sys(
            _mixed_pow()), 15), np.array([0.6, -0.4]), 200, 5)
    else:
        plan, ic, lo = pp.outer_ss_plan(), pp.IC, pp.LO
        n_lanes = 100 if case == "outer_ss_small" else pp.B
    tape = pp.ProtoTape(ht.plan_to_arrays(plan), cuda)
    tc = pp.realistic_buffer(plan, ic, n_lanes, lo, cuda)
    ref = pp.phase_body_plain(plan, lo, plan.order, plan.n_eq)(tc)
    n0 = jk.LAUNCHES["proto_phase"]
    # the kernel takes B4's (K+1, W, B) buffer
    got = pp.phase_f32(tape, tc.permute(1, 0, 2).contiguous(),
                       lo).permute(1, 0, 2)
    torch.cuda.synchronize()
    assert jk.LAUNCHES["proto_phase"] == n0 + 1
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[:, :lo], tc[:, :lo])
    assert float(pp.per_order_rel(got, ref)[lo:].max()) <= pp.RTOL


@pytest.mark.gpu
def test_proto_phase_rejects_bad_inputs(cuda):
    plan = pp.outer_ss_plan(8)
    tape = pp.ProtoTape(ht.plan_to_arrays(plan), cuda)
    tc = pp.realistic_buffer(plan, pp.IC, 4, 4, cuda).permute(
        1, 0, 2).contiguous()
    with pytest.raises(ValueError):
        pp.phase_f32(tape, tc.double(), 4)  # dtype
    with pytest.raises(ValueError):
        pp.phase_f32(tape, tc.permute(1, 0, 2).contiguous(), 4)  # layout
    with pytest.raises(ValueError):
        pp.phase_f32(tape, tc.cpu(), 4)  # the tables live on the card
    with pytest.raises(ValueError):
        pp.phase_f32(tape, tc, 0)  # order 0 is not the kernel's
