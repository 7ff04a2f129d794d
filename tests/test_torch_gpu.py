"""The port's CUDA kernels against their plain torch twins, on a CUDA
device.  This file imports neither JAX nor the JAX package, so it runs
where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Without a CUDA device every test skips.  ``chip_smoke.py`` makes the same
comparisons at the main path's shapes."""

import pickle

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

from heyoka_tpu_torch.tools import cases as c5
from heyoka_tpu_torch.tools.cases import ROLLED_TEST_WIDTH, ROUTES, route_case

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


# -- propagate_grid, continuous output and pickling on the card ----------------

#: the kernel each route's per-step drivers launch (``LAUNCHES`` keys)
ROUTE_KERNEL = {"b2": "jet", "b3": "jet_rolled", "b4": "phase"}


def _route_pair(cuda, monkeypatch, route, B=6, seed=8):
    """A route's small case on the CPU and on the card (tools/cases.py)."""
    if route == "b3":
        monkeypatch.setattr(tbatch, "ROLLED_MIN_WIDTH", ROLLED_TEST_WIDTH)
    sys_, st = route_case(ht, route, B, seed)
    kw = dict(tol=1e-12, high_accuracy=True)
    return (ht.taylor_adaptive_batch(sys_, st, device="cpu", **kw),
            ht.taylor_adaptive_batch(sys_, st, device=cuda, **kw))


def _only(route, n0):
    """Launches since ``n0``: the route's kernel only, at least once."""
    grown = {k for k in jk.LAUNCHES if jk.LAUNCHES[k] != n0[k]}
    return grown == {ROUTE_KERNEL[route]}


def _close(a, b, tol=1e-11):
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
def test_grid_on_cuda_matches_cpu(cuda, monkeypatch, route):
    c, g = _route_pair(cuda, monkeypatch, route)
    for grid in (np.linspace(0.0, 3.0, 13), np.linspace(3.0, -1.0, 9)):
        n0 = dict(jk.LAUNCHES)
        rg = g.propagate_grid(grid)
        torch.cuda.synchronize()
        assert _only(route, n0)
        rc = c.propagate_grid(grid)
        assert rg[0] == rc[0]
        assert all(o == ht.TaylorOutcome.time_limit for o in rg[0])
        _close(rg[4], rc[4])
        _close(g.state, c.state)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
def test_c_output_on_cuda_matches_cpu(cuda, monkeypatch, route):
    c, g = _route_pair(cuda, monkeypatch, route)
    targets = np.array([3.0, 3.0, -1.5, 3.0, 2.0, 3.0])
    n0 = dict(jk.LAUNCHES)
    rg = g.propagate_until(targets, c_output=True)
    torch.cuda.synchronize()
    assert _only(route, n0)
    rc = c.propagate_until(targets, c_output=True)
    assert rg[0] == rc[0]
    np.testing.assert_array_equal(rg[4].n_steps, rg[3])
    q = np.linspace(0.0, 1.0, 7)[:, None] * targets[None, :]
    _close(rg[4](q), rc[4](q))
    # the dense output of one more step, at mid-step
    g.step()
    c.step()
    _close(g.update_d_output(g.time - g.last_h / 2),
           c.update_d_output(c.time - c.last_h / 2))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
def test_pickle_on_cuda(cuda, monkeypatch, route):
    _, g = _route_pair(cuda, monkeypatch, route)
    g.propagate_for(1.0)
    q = pickle.loads(pickle.dumps(g))
    assert q.engine_report() == g.engine_report()
    rg = g.propagate_until(2.0, c_output=True)
    rq = q.propagate_until(2.0, c_output=True)
    for a, b in ((g.state, q.state), (g.tc, q.tc), (rg[3], rq[3])):
        np.testing.assert_array_equal(a, b)
    co = pickle.loads(pickle.dumps(rg[4]))
    t = np.full(g.batch_size, 1.5)
    np.testing.assert_array_equal(co(t), rg[4](t))
    np.testing.assert_array_equal(rq[4](t), rg[4](t))


# -- events: the jets' sv-func rows and the event paths on the card ------------

def _ev_tape(sys_, evs, order, cuda, cls):
    plan = build_plan(taylor_decompose_sys(sys_, extra_outputs=evs), order)
    return cls(ht.plan_to_arrays(plan), cuda)


def _plain_rows(jet_fn):
    return {jk.jet: jk.jet_plain, jr.jet_rolled: jr.jet_rolled_plain}[jet_fn]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nbody3", "mascon12_b2", "mascon12_b3",
                                  "pendulum"])
def test_event_rows_match_plain(cuda, name):
    # the sv-func rows (the event equations, after the state rows) of
    # kernels B2, B3 (an alias-form event x - 1.5, read through its root)
    # and B4 against their plain versions, 1e-13 relative per order; the
    # state rows equal those of the tape without events bit for bit
    B, K = 200, 15
    if name == "pendulum":
        sys_ = ht.models.pendulum()
        x, v = ht.make_vars("x", "v")
        evs = [v, x * x - 0.01]
        st, pars, t = pendulum_lanes(B, 3), np.zeros((B, 0)), np.zeros(B)
    else:
        key = name.split("_")[0]
        sys_ = SYSTEMS[key]()
        names = [lhs.name for lhs, _ in sys_]
        x, y, z = (ht.make_vars(n) for n in names[:3])
        evs = [x - 1.5, x * x + y * y + z * z - 1.0, y]
        st, pars, t = _inputs(key, B, 4)
    cls, jet_fn = {"nbody3": (jk.JetTape, jk.jet),
                   "mascon12_b2": (jk.JetTape, jk.jet),
                   "mascon12_b3": (jr.RolledTape, jr.jet_rolled),
                   "pendulum": (jp.PhaseTape, jp.jet_phase)}[name]
    tape = _ev_tape(sys_, evs, K, cuda, cls)
    bare = _ev_tape(sys_, [], K, cuda, cls)
    args = (_dev(st.T, cuda), _dev(pars.T, cuda), _dev(t, cuda))
    tc, norms = jet_fn(tape, *args)
    tc0, _ = jet_fn(bare, *args)
    assert tc.shape == (tape.n_eq + len(evs), K + 1, B)
    assert torch.equal(tc[:tape.n_eq], tc0)
    if jet_fn is jp.jet_phase:
        buf = jk._seed_plain(tape, *args)
        jp.order0(tape, buf)
        jp.phase_plain(tape, buf, 1)
        tc_p, norms_p = jk._rows(tape, buf), jk._norms(tape, buf)
    else:
        tc_p, norms_p = _plain_rows(jet_fn)(tape, *args)
    assert float(_per_order_rel(tc, tc_p).max()) <= 1e-13
    nrel = (norms - norms_p).abs().amax(1) / norms_p.amax(1)
    assert float(nrel.max()) <= 1e-13


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
def test_events_on_cuda_match_cpu(cuda, monkeypatch, route):
    # a terminal and a non-terminal event on each route: the same stops,
    # hits and states as the CPU run, the route's kernel only, never B1
    if route == "b3":
        monkeypatch.setattr(tbatch, "ROLLED_MIN_WIDTH", ROLLED_TEST_WIDTH)
    runs = []
    for dev in ("cpu", cuda):
        sys_, st = route_case(ht, route, 6, 2)
        names = [lhs.name for lhs, _ in sys_]
        a, b = (ht.make_vars(n) for n in names[:2])
        hits = []
        ta = ht.taylor_adaptive_batch(
            sys_, st, tol=1e-12, high_accuracy=True, device=dev,
            t_events=[ht.t_event(b - 0.05 * a, callback=lambda tb, d, l:
                                 len(hits) % 3 != 2)],
            nt_events=[ht.nt_event(a - 0.1, lambda tb, t, d, l:
                                   hits.append((l, t, d)))])
        n0 = dict(jk.LAUNCHES)
        res = ta.propagate_until(4.0)
        grid = ta.propagate_grid(np.linspace(4.0, 6.0, 9))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert _only(route, n0)
        runs.append((ta, res, grid, sorted(hits)))
    (c, rc, gc, hc), (g, rg, gg, hg) = runs
    assert rg[0] == rc[0] and gg[0] == gc[0]
    assert [(l, d) for l, _, d in hg] == [(l, d) for l, _, d in hc]
    np.testing.assert_allclose([t for _, t, _ in hg], [t for _, t, _ in hc],
                               rtol=0, atol=1e-11)
    _close(g.state, c.state)
    _close(np.nan_to_num(gg[4]), np.nan_to_num(gc[4]))
    assert g.engine_report()["propagate_engine"] == "events"


# -- one and three lanes: the scalar integrator's and small ensembles' ------


def _guarded(t, guard=4096, fill=12345.0):
    """``t`` copied into the middle of a buffer of ``fill`` guards: (the
    copy, the whole buffer)."""
    flat = torch.full((t.numel() + 2 * guard,), fill, dtype=t.dtype,
                      device=t.device)
    flat[guard:guard + t.numel()] = t.reshape(-1)
    return flat[guard:guard + t.numel()].view(t.shape), flat


def _guards_kept(flat, guard=4096, fill=12345.0):
    return bool((flat[:guard] == fill).all() and (flat[-guard:] == fill).all())


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("name", ["nbody3", "handbuilt"])
def test_jet_and_prop_kernels_at_few_lanes(cuda, name, B):
    # B2 and B1 with one or three lanes (one block each) against the twins
    K = 19
    tape = _tape(name, K, cuda)
    st, pars, t = _inputs(name, B, 21)
    args = (_dev(st.T, cuda), _dev(pars.T, cuda), _dev(t, cuda))
    tc, norms = jk.jet(tape, *args)
    tc_p, norms_p = jk.jet_plain(tape, *args)
    assert float(_per_order_rel(tc, tc_p).max()) <= 1e-13
    assert float(((norms - norms_p).abs().amax(1)
                  / norms_p.amax(1)).max()) <= 1e-13
    if name != "nbody3":
        return  # B1 carries no time
    aux = torch.stack([_dev(np.full(B, np.inf), cuda), _dev(np.ones(B), cuda),
                       _dev(np.full(B, 3.0), cuda), _dev(np.zeros(B), cuda),
                       _dev(np.ones(B), cuda)])
    budget = torch.full((1, B), 1000, dtype=torch.int32, device=cuda)
    k = jk.prop(tape, args[0], args[1], aux, budget, 16, True)
    p = jk.prop_plain(tape, args[0], args[1], aux, budget, 16, True)
    assert torch.equal(k[2], p[2])
    torch.testing.assert_close(k[0], p[0], rtol=0, atol=1e-11)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("name", ["mascon12", "mascon512"])
def test_jet_rolled_kernel_at_few_lanes(cuda, name, B):
    # B3 with one or three lanes: mascon-12 on the smem layout, mascon-512
    # on the global layout with its scratch sized for an SM's lanes
    tape = _tape(name, 19, cuda, jr.RolledTape)
    args = (_dev(_orbits(B, 17).T, cuda),
            torch.zeros((0, B), dtype=torch.float64, device=cuda),
            torch.zeros(B, dtype=torch.float64, device=cuda))
    _rolled_vs_twin_and_b2(cuda, tape, args)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3])
def test_phase_kernel_at_few_lanes_every_shape(cuda, B):
    # B4 with one or three live lanes in a block of up to 32, at every
    # shape it takes: equal to the twin, and nothing written outside the
    # buffer (guards on both sides)
    K = 19
    tape = _phase_tape("pendulum", K, cuda)
    st0, pars = PHASE_CASES["pendulum"][1:]
    tc0 = seeded_buffer(tape, *phase_lanes(st0, pars, B, 6), cuda)
    tc_p = jp.phase_plain(tape, tc0.clone(), 1)
    shapes = [(None, None, None)] + jp.sweep_shapes(tape, 8)
    for lay, L, nt in shapes:
        buf, flat = _guarded(tc0)
        jp._phase_cuda(tape, buf, 1, L, nt, lay)
        torch.cuda.synchronize()
        assert _guards_kept(flat), (lay, L, nt)
        rel = _per_order_rel(buf.permute(1, 0, 2), tc_p.permute(1, 0, 2))
        assert float(rel.max()) <= 1e-13, (lay, L, nt)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
def test_scalar_on_cuda_matches_cpu(cuda, monkeypatch, route):
    # the scalar integrator on the card: its route's kernels (B1 and B2 on
    # b2, B3 on b3, B4 on b4), equal to its CPU run
    if route == "b3":
        monkeypatch.setattr(tbatch, "ROLLED_MIN_WIDTH", ROLLED_TEST_WIDTH)
    sys_, st = route_case(ht, route, 1, 4)
    kw = dict(tol=1e-12, high_accuracy=True)
    c = ht.taylor_adaptive(sys_, st[0], device="cpu", **kw)
    g = ht.taylor_adaptive(sys_, st[0], device=cuda, **kw)
    n0 = dict(jk.LAUNCHES)
    sc, sg = c.step(), g.step()
    rc, rg = c.propagate_until(4.0), g.propagate_until(4.0)
    torch.cuda.synchronize()
    grown = {k for k in jk.LAUNCHES if jk.LAUNCHES[k] != n0[k]}
    assert grown == ({"jet", "prop"} if route == "b2"
                     else {ROUTE_KERNEL[route]})
    assert sg[0] == sc[0] and sg[1] == pytest.approx(sc[1], rel=1e-12)
    assert rg[0] == rc[0] and rg[3] == rc[3] and g.time == 4.0
    _close(g.state, c.state)


@pytest.mark.gpu
def test_ensemble_on_cuda_matches_cpu(cuda):
    # an ensemble of 5 instances of the 3-body template: B1 and B2, equal
    # to the CPU ensemble; a one-device mesh equal to the plain call
    sys_, st = route_case(ht, "b2", 5, 6)
    kw = dict(tol=1e-12, high_accuracy=True)
    res = {}
    for dev in ("cpu", cuda):
        ta = ht.taylor_adaptive(sys_, st[0], device=dev, **kw)
        n0 = dict(jk.LAUNCHES)
        res[str(dev)] = ht.ensemble_propagate_until(ta, 3.0, 5,
                                                    {"state": st})
        if dev != "cpu":
            torch.cuda.synchronize()
            grown = {k for k in jk.LAUNCHES if jk.LAUNCHES[k] != n0[k]}
            assert grown == {"jet", "prop"}
            rm = ht.ensemble_propagate_until(ta, 3.0, 5, {"state": st},
                                             mesh=["cuda:0"])
            assert torch.equal(rm["state"].cpu(), res[str(dev)]["state"]
                               .cpu())
    c, g = res["cpu"], res[str(cuda)]
    assert g["state"].device.type == "cuda"
    assert torch.equal(g["outcome"].cpu(), c["outcome"])
    assert torch.equal(g["nsteps"].cpu(), c["nsteps"])
    _close(g["state"].cpu().numpy(), c["state"].numpy())


#: the variational systems of each route (tests/test_torch_var.py's):
#: the system, its arguments and order, and a base state
VAR_ROUTES = {
    "b2": (lambda: ht.models.pcr3bp(mu=0.01), ht.VarArgs.vars, 1,
           [-0.45, 0.80, -0.80, -0.45]),
    "b3": (lambda: ht.models.cr3bp(mu=0.01), ht.VarArgs.vars, 1,
           [-0.45, 0.80, 0.05, -0.80, -0.45, 0.02]),
    "b4": (ht.models.pendulum, ht.VarArgs.vars, 2, [0.05, 0.025]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("route", ROUTES)
def test_var_on_cuda_matches_cpu(cuda, monkeypatch, route):
    # a variational batch and scalar on the card: their route's kernels,
    # states and Taylor maps equal to the CPU run
    if route == "b3":
        monkeypatch.setattr(tbatch, "ROLLED_MIN_WIDTH", ROLLED_TEST_WIDTH)
    make, args, order, base = VAR_ROUTES[route]
    vs = ht.var_ode_sys(make(), args, order)
    st = np.array(base)[None] + 1e-3 * np.random.default_rng(9) \
        .standard_normal((4, len(base)))
    kw = dict(tol=1e-13, high_accuracy=True)
    d = 1e-4 * np.arange(1, vs.n_vargs + 1)
    out = {}
    for dev in ("cpu", cuda):
        tb = ht.taylor_adaptive_batch(vs, st, device=dev, **kw)
        ta = ht.taylor_adaptive(vs, st[0], device=dev, **kw)
        n0 = dict(jk.LAUNCHES)
        tb.propagate_until(3.0)
        ta.propagate_until(3.0)
        if dev != "cpu":
            torch.cuda.synchronize()
            grown = {k for k in jk.LAUNCHES if jk.LAUNCHES[k] != n0[k]}
            assert grown == ({"jet", "prop"} if route == "b2"
                             else {ROUTE_KERNEL[route]})
        out[str(dev)] = (tb.state, tb.eval_taylor_map(d), ta.state,
                         ta.eval_taylor_map(d))
    for g, c in zip(out[str(cuda)], out["cpu"]):
        _close(g, c)


@pytest.mark.gpu
def test_cfunc_on_cuda_matches_cpu(cuda):
    # the tape's rows as torch ops on the card: results there, equal to
    # the CPU's to 1e-14; a CPU tensor is refused, not moved
    x, y = ht.make_vars("x", "y")
    fns = [x * ht.sin(y) + ht.par[0] * (x * x + y * y) ** -1.5,
           ht.kepE(0.3, y) + ht.time * ht.tanh(x), 2.0]
    pts = np.random.default_rng(10).uniform(0.2, 1.0, (4096, 2))
    pars = np.random.default_rng(11).uniform(0.0, 1.0, (4096, 1))
    tm = np.linspace(0.0, 3.0, 4096)
    g = ht.make_cfunc(fns, vars=[x, y], device=cuda)
    c = ht.make_cfunc(fns, vars=[x, y], device="cpu")
    out = g(torch.as_tensor(pts, device=cuda), pars=pars, time=tm)
    assert out.device.type == "cuda" and out.shape == (4096, 3)
    _close(out.cpu().numpy(), c(pts, pars=pars, time=tm).numpy(), 1e-14)
    one = g(pts[0], pars=pars[0], time=1.5)
    _close(one.cpu().numpy(), c(pts[0], pars=pars[0], time=1.5).numpy(),
           1e-14)
    with pytest.raises(ValueError, match="lies on cpu"):
        g(torch.as_tensor(pts))


# -- BASELINE config 5 (chip_smoke.py phase 23) --------------------------------


def _c5_arrays(sys_, K):
    return ht.plan_to_arrays(build_plan(taylor_decompose_sys(sys_), K))


@pytest.mark.gpu
def test_config5_geopot_b1_chunk_matches_plain(cuda):
    # the degree-4 geopotential (270 columns) at order 19: one 64-step B1
    # chunk against its twin (flags equal, the state within 1e-11
    # relative) and B2 per order (1e-13)
    B = 256
    tape = jk.JetTape(_c5_arrays(c5.geopot_sys(ht, 4), 19), cuda)
    st = _dev(c5.geopot_lanes(B, 2).T, cuda)
    pars = torch.zeros(0, B, dtype=torch.float64, device=cuda)
    aux = torch.stack([_dev(np.full(B, np.inf), cuda), _dev(np.ones(B), cuda),
                       _dev(np.full(B, 1e7), cuda), _dev(np.zeros(B), cuda),
                       _dev(np.ones(B), cuda)])
    budget = torch.full((1, B), 2**31 - 1, dtype=torch.int32, device=cuda)
    n0 = jk.LAUNCHES["prop"]
    k = jk.prop(tape, st, pars, aux, budget, 64, True)
    torch.cuda.synchronize()
    assert jk.LAUNCHES["prop"] == n0 + 1
    p = jk.prop_plain(tape, st, pars, aux, budget, 64, True)
    assert torch.equal(k[2], p[2]) and bool((k[2][0] == 64).all())
    rel = ((k[0] - p[0]).abs().amax(1) / p[0].abs().amax(1)).max()
    assert float(rel) <= 1e-11
    tc, _ = jk.jet(tape, st, pars)
    tc_p, _ = jk.jet_plain(tape, st, pars)
    assert float(_per_order_rel(tc, tc_p).max()) <= 1e-13


@pytest.mark.gpu
def test_config5_drag_b4_matches_plain(cuda):
    # the drag ODE (2,388 columns, four parameters a lane, the time) at
    # order 19 on B4's global layout: 1e-13 relative per order from lo = 1
    B = 96
    tape = jp.PhaseTape(_c5_arrays(c5.drag_sys(ht, 4), 19), cuda)
    t = np.random.default_rng(3).uniform(0.0, 86400.0, B)
    tc0 = seeded_buffer(tape, c5.geopot_lanes(B, 4), c5.drag_pars(B, 5), t,
                        cuda)
    n0 = jk.LAUNCHES["phase"]
    tc_k = jp.phase(tape, tc0.clone(), 1)
    torch.cuda.synchronize()
    assert jk.LAUNCHES["phase"] == n0 + 1
    tc_p = jp.phase_plain(tape, tc0.clone(), 1)
    assert bool(torch.isfinite(tc_k).all())
    rel = _per_order_rel(tc_k.permute(1, 0, 2), tc_p.permute(1, 0, 2))
    assert float(rel.max()) <= 1e-13


@pytest.mark.gpu
@pytest.mark.parametrize("order", [0, 1])
def test_sgp4_on_cuda_matches_cpu(cuda, order):
    # the propagator's tape as torch ops on the card, the derivatives
    # through torch.func there: within 1e-12 of the CPU's largest
    # magnitude per output (the card's libm)
    g = c5.sgp4_population(64)
    tm = np.random.default_rng(6).uniform(0.0, 1440.0, (4, 64))
    pg = ht.models.SGP4Propagator(g, diff_order=order, device=cuda)
    pc = ht.models.SGP4Propagator(g, diff_order=order, device="cpu")
    out = pg(torch.as_tensor(tm, device=cuda))
    assert out.device.type == "cuda" and out.shape == (4, 64, pg.nouts)
    want = pc(tm)
    err = (out.cpu() - want).abs().reshape(-1, pg.nouts).amax(0)
    scale = want.abs().reshape(-1, pg.nouts).amax(0)
    assert bool((err <= 1e-12 * scale).all())
    with pytest.raises(ValueError, match="lies on cpu"):
        pg(torch.as_tensor(tm))


# -- the dense trig series (kernel S1) and B4's series rows ------------------

def _series_tables(q, d, n, seed, dev):
    from heyoka_tpu_torch.expr import series
    from heyoka_tpu_torch.taylor import series_jet as sj
    amp, ph = c5.random_series(np.random.default_rng(seed), n, q, d)
    ph[:, 1] *= 2000.0  # phases of thousands of radians, as ELP2000's
    return sj.tables_on(series.add(amp, ph), dev)


@pytest.mark.gpu
@pytest.mark.parametrize("q,d", [(0, 1), (0, 4), (2, 4), (1, 2), (3, 7)])
def test_series_kernel_matches_plain(cuda, q, d):
    # kernel S1 against its twin per order, within 1e-13 of the order's
    # sum of absolute terms: the shifts round alike, the recurrence uses
    # fma in the kernel and the sums over terms run in other orders; two
    # runs of the kernel give the same bits (no atomics)
    from heyoka_tpu_torch.taylor import series_jet as sj
    B, K = 203, 19
    tab = _series_tables(q, d, 3001, 10 * q + d, cuda)
    rng = np.random.default_rng(q + d)
    u0 = torch.as_tensor(rng.uniform(-0.5, 0.5, B), device=cuda)
    u1 = torch.as_tensor(rng.uniform(0.5, 1.5, B), device=cuda)
    n0 = jk.LAUNCHES["series"]
    got = sj.series_jet(tab, u0, u1, K)
    torch.cuda.synchronize()
    assert jk.LAUNCHES["series"] == n0 + 1
    want, scale = sj.series_jet_plain(tab, u0, u1, K, with_scale=True)
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= 1e-13 * scale).all())
    assert torch.equal(sj.series_jet(tab, u0, u1, K), got)


@pytest.mark.gpu
def test_series_kernel_value_and_refusals(cuda):
    # order 0 at many points (the cfunc's rule) against the twin, and the
    # inputs S1 refuses
    from heyoka_tpu_torch.taylor import series_jet as sj
    tab = _series_tables(0, 4, 500, 3, cuda)
    u = torch.linspace(-0.5, 0.5, 70_001, dtype=torch.float64, device=cuda)
    got = sj.series_value(tab.name, u)
    want, scale = sj.series_jet_plain(tab, u, torch.zeros_like(u), 0,
                                      with_scale=True)
    want, scale = want[0], scale[0]
    assert bool(((got - want).abs() <= 1e-13 * scale).all())
    with pytest.raises(ValueError):
        sj.series_jet(tab, u.float(), u.float(), 3)
    with pytest.raises(ValueError):
        sj.series_jet(tab, u.cpu(), u.cpu(), 3)
    big = _series_tables(8, 4, 20, 4, cuda)
    with pytest.raises(ValueError, match="coefficients"):
        sj.series_jet(big, u, u, 3)


@pytest.mark.gpu
def test_phase_kernel_series_rows_on_both_layouts(cuda):
    # the ELP2000 tape at order 19: order0 fills the series buffer through
    # S1; B4 copies the series columns' rows from it bit for bit on both
    # layouts and every block shape, and the rest agrees with the twin
    # (1e-13 relative per order) fed the same buffer
    B, K = 77, 19
    arrays = ht.plan_to_arrays(build_plan(taylor_decompose_sys(
        c5.elp_sys(ht, 1e-4)), K))
    tape = jp.PhaseTape(arrays, cuda)
    t = c5.series_times(B, 5)
    tc0 = seeded_buffer(tape, np.zeros((B, 3)), np.zeros((B, 0)), t, cuda)
    n0 = jk.LAUNCHES["series"]
    ser = jp.order0(tape, tc0)
    assert jk.LAUNCHES["series"] == n0 + tape.n_ser
    cols = [c for c, _, _ in tape.series]
    want = jp.phase_plain(tape, tc0.clone(), 1, ser)
    assert torch.equal(want[:, cols], ser)
    shapes = jp.sweep_shapes(tape, 8, lanes=(1, 3, 32))
    assert {lay for lay, _, _ in shapes} == {"smem", "global"}
    for lay, L, nt in shapes:
        got = jp._phase_cuda(tape, tc0.clone(), 1, L, nt, lay, ser=ser)
        assert torch.equal(got[:, cols], ser), (lay, L, nt)
        rel = _per_order_rel(got.permute(1, 0, 2), want.permute(1, 0, 2))
        assert float(rel.max()) <= 1e-13, (lay, L, nt)
    with pytest.raises(ValueError, match="series buffer"):
        jp.phase(tape, tc0.clone(), 1)


@pytest.mark.gpu
def test_series_batch_on_cuda_matches_cpu(cuda):
    # the ELP2000 and planet-9 tapes through S1 and B4 against the twins:
    # every lane lands with time_limit, states within 1e-12 relative
    for sys_, t_end, half in ((c5.elp_sys(ht, 1e-5), 0.002, 0.5),
                              (c5.p9_sys(ht, 1e-7), 0.05, 0.5)):
        t0 = c5.series_times(6, 1, half)
        kw = dict(tol=1e-15, time=t0)
        n0 = dict(jk.LAUNCHES)
        tg = ht.taylor_adaptive_batch(sys_, np.zeros((6, len(sys_))),
                                      device=cuda, **kw)
        assert tg.engine_report()["series"] == "hy_series_jet_f64"
        rg = tg.propagate_for(t_end)
        assert jk.LAUNCHES["series"] > n0["series"]
        assert jk.LAUNCHES["phase"] > n0["phase"]
        assert jk.LAUNCHES["jet"] == n0["jet"]
        tc_ = ht.taylor_adaptive_batch(sys_, np.zeros((6, len(sys_))),
                                       device="cpu", **kw)
        rc = tc_.propagate_for(t_end)
        assert all(o == ht.TaylorOutcome.time_limit for o in rg[0])
        np.testing.assert_array_equal(tg.time, t0 + t_end)
        scale = np.abs(tc_.state).max()
        np.testing.assert_allclose(tg.state, tc_.state, rtol=0,
                                   atol=1e-12 * scale)
        # the step counts agree but for a sub-ulp landing step
        assert int(np.abs(np.asarray(rg[3]) - np.asarray(rc[3])).max()) <= 1
