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
           "handbuilt_mixed": lambda: _handbuilt(mixed=True)}


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
    if name == "mascon12":
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


@pytest.mark.gpu
def test_jet_rolled_rejects_bad_inputs(cuda):
    tape = _tape("mascon12", 8, cuda, jr.RolledTape)
    st = _dev(_inputs("mascon12", 4, 0)[0].T, cuda)
    pars = torch.zeros(0, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        jr.jet_rolled(tape, st.float(), pars)
    with pytest.raises(ValueError):
        jr.jet_rolled(tape, st.cpu(), pars)  # tables on the card


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
