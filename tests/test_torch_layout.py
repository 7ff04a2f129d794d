"""The block layout of kernels B1/B2 (``jet_kernels.block_layout``), which
the wrappers choose from the tape's width and order, and the wrappers'
CPU route to the plain twins, on the CPU.  The kernels themselves are held
against their twins in tests/test_torch_gpu.py."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.models import nbody
from heyoka_tpu_torch.taylor import batch as tbatch
from heyoka_tpu_torch.taylor import jet_kernels as jk
from heyoka_tpu_torch.taylor import jet_rolled as jr
from heyoka_tpu_torch.taylor.compact import build_plan
from heyoka_tpu_torch.tools import GCONST, IC, MASSES, jet_scan

from heyoka_tpu_torch.tools import mascon_body

CSRC = Path(jk.__file__).resolve().parent.parent / "csrc" / "taylor_jet.cu"
NBODY3_BASE = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0,
                        0, 1.5, 0, -0.8, 0, 0], float)


def _mascon12():
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1.0, 1.0, (48, 3))
    pts = pts[np.linalg.norm(pts, axis=1) <= 1.0][:12]
    masses = rng.uniform(0.5, 1.0, 12)
    return ht.models.mascon(masses=(masses / masses.sum()).tolist(),
                            positions=pts.tolist(), omega=(0.0, 0.0, 0.3))


def _handbuilt():
    x, y, z = ht.make_vars("x", "y", "z")
    return [
        (x, ht.par[0] * y / (1.0 + x * x) + ht.sqrt(1.5 + y * y)),
        (y, -x / ht.sqrt(x * x + y * y + 0.3) + 0.1 * ht.time_ * z),
        (z, (x * x + z * z + 2.0) ** -1.5 - ht.par[1] * z),
    ]


SYSTEMS = {
    "outer_ss": lambda: nbody(6, masses=MASSES, Gconst=GCONST),
    "nbody3": lambda: nbody(3, masses=[1.0, 1e-3, 2e-3]),
    "mascon12": _mascon12,
    "mascon128": lambda: ht.models.mascon(**mascon_body(128)[0]),
    "mascon512": lambda: ht.models.mascon(**mascon_body(512)[0]),
    "handbuilt": _handbuilt,
}


@functools.cache
def _arrays(name, order):
    return ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(SYSTEMS[name]()), order))


# (tape, W, {K: one lane's bytes}), counted by hand: 8 ((K+1) W + 16)
HAND = [
    ("outer_ss", 381, {10: 33_656, 15: 48_896, 19: 61_088}),
    ("nbody3", 98, {10: 8_752, 15: 12_672, 19: 15_808}),
    ("mascon12", 237, {10: 20_984, 15: 30_464, 19: 38_048}),
    ("mascon128", 2325, {10: 204_728, 15: 297_728, 19: 372_128}),
    ("mascon512", 9237, {10: 812_984, 15: 1_182_464, 19: 1_478_048}),
]


@pytest.mark.parametrize("name,W,K,per", [
    (name, W, K, per) for name, W, by_k in HAND for K, per in by_k.items()])
def test_block_layout(name, W, K, per):
    assert int(_arrays(name, K)["meta"][0]) == W
    assert jk.lane_bytes(W, K) == per
    lanes, smem = jk.block_layout(W, K)
    if per > 232_448:  # one lane's block does not fit a block's 227 KB
        assert (lanes, smem) == (jk.GLOBAL_LANES, None)
    else:
        assert lanes == min(jk.LANES, 232_448 // per) >= 1
        assert smem == lanes * per <= 232_448


@pytest.mark.parametrize("W,K,layout", [
    (1452, 19, "smem"),     # 8 (20 * 1452 + 16) = 232,448 exactly
    (1453, 19, "global"),   # 232,608
    (2640, 10, "smem"),     # 8 (11 * 2640 + 16) = 232,448 exactly
    (2641, 10, "global"),
])
def test_block_layout_at_the_limit(W, K, layout):
    lanes, smem = jk.block_layout(W, K)
    assert (smem is None) == (layout == "global")
    if smem is not None:
        assert (lanes, smem) == (1, 232_448)


@pytest.mark.parametrize("name,value", [
    ("kSmemMax", jk.SMEM_MAX), ("kLaneScalars", jk.LANE_SCALARS),
    ("kGlobalLanes", jk.GLOBAL_LANES), ("kMaxThreads",
                                        max(jk.THREADS, jk.GLOBAL_THREADS))])
def test_constants_match_the_kernel_source(name, value):
    # the Python side counts the same bytes the kernels take
    m = re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text())
    assert m and int(m.group(1)) == value


def _cpu_pair(name, tol, **kw):
    st = {"outer_ss": lambda: IC[None] * np.ones((2, 1)),
          "nbody3": lambda: NBODY3_BASE[None] * np.ones((2, 1)),
          "pendulum": lambda: np.array([[0.05, 0.025]] * 2),
          }.get(name, lambda: np.array([[2.0, 0.0, 0.0, 0.0, 0.7, 0.0]] * 2))
    sys_ = ht.models.pendulum() if name == "pendulum" else SYSTEMS[name]()
    return ht.taylor_adaptive_batch(sys_, st(), tol=tol, device="cpu", **kw)


@pytest.mark.parametrize("name,min_width,layout", [
    ("outer_ss", None, "smem"),
    ("nbody3", None, "smem"),
    ("pendulum", None, None),        # the phase route (B4)
    ("mascon12", 64, "rolled"),      # the rolled route (B3)
    ("mascon128", 10**6, "global"),  # B1/B2 on a tape too wide for smem
])
def test_engine_report_names_the_layout(monkeypatch, name, min_width,
                                        layout):
    if min_width is not None:
        monkeypatch.setattr(tbatch, "ROLLED_MIN_WIDTH", min_width)
    ta = _cpu_pair(name, 1e-15, high_accuracy=True)
    rep = ta.engine_report()
    if layout is None:
        assert rep["layout"] is None and rep["prop"] is None
        return
    if layout == "rolled":  # kernel B3's layout: one lane a block
        assert rep["prop"] is None and rep["jet"] == "jet_rolled_plain"
        assert rep["layout"] == jr.layout_report(ta._jtape)
        assert rep["layout"]["layout"] == "smem"
        return
    assert rep["jet"] == "jet_plain" and rep["prop"] == "prop_plain"
    lanes, smem = jk.block_layout(ta._jtape.width, ta.order)
    # the tables join the jets in shared memory; the global layout leaves
    # them where they are
    assert rep["layout"] == dict(
        layout=layout, lanes_per_block=lanes, smem_bytes=smem,
        tables="smem" if layout == "smem" else "global")


def _jet_args(name, B, seed):
    rng = np.random.default_rng(seed)
    if name == "handbuilt":
        st = rng.uniform(-1.0, 1.0, (B, 3))
        return (torch.as_tensor(st.T.copy()),
                torch.as_tensor(rng.uniform(0.5, 1.5, (2, B))),
                torch.as_tensor(rng.uniform(0.0, 2.0, B)))
    if name == "nbody3":
        st = NBODY3_BASE[None] + 0.01 * rng.standard_normal((B, 18))
    else:  # a mascon body: orbits at r ~ 2
        ang = rng.uniform(0, 2 * np.pi, B)
        st = np.stack([2 * np.cos(ang), 2 * np.sin(ang), np.zeros(B),
                       -0.7 * np.sin(ang), 0.7 * np.cos(ang), np.zeros(B)],
                      1)
    return (torch.as_tensor(st.T.copy()), torch.zeros((0, B),
                                                       dtype=torch.float64),
            torch.zeros(B, dtype=torch.float64))


@pytest.mark.parametrize("name,K", [("nbody3", 12), ("handbuilt", 9),
                                    ("mascon128", 19)])
def test_jet_wrapper_on_cpu_runs_the_twin(name, K):
    # whatever the layout the card would take, a CPU tensor runs jet_plain
    tape = jk.JetTape(_arrays(name, K), "cpu")
    args = _jet_args(name, 3, 1)
    before = dict(jk.LAUNCHES)
    got = jk.jet(tape, *args)
    assert jk.LAUNCHES == before
    for a, b in zip(got, jk.jet_plain(tape, *args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("high_accuracy", [True, False])
def test_prop_wrapper_on_cpu_runs_the_twin(high_accuracy):
    B = 5
    tape = jk.JetTape(_arrays("nbody3", 12), "cpu")
    st, pars, _ = _jet_args("nbody3", B, 2)
    aux = torch.tensor([[np.inf] * B, [1.0] * B, [1.0, 10, 10, 10, 10],
                        [0.0] * B, [1, 1, 0, 1, 1]], dtype=torch.float64)
    auxi = torch.tensor([[100, 100, 100, 3, 100]], dtype=torch.int32)
    before = dict(jk.LAUNCHES)
    got = jk.prop(tape, st, pars, aux, auxi, 8, high_accuracy)
    assert jk.LAUNCHES == before
    ref = jk.prop_plain(tape, st, pars, aux, auxi, 8, high_accuracy)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # the lane protocol: near, inactive, budget and free lanes
    n, near, err = ref[2].tolist()
    assert near[0] == 1 and n[2] == 0 and n[3] == 3 and n[4] == 8
    assert not any(err)


@pytest.mark.parametrize("name,K", [("outer_ss", 19), ("mascon128", 19),
                                    ("mascon512", 10)])
def test_launch_config(name, K):
    # the launch of B1/B2: the jets in shared memory with the tables behind
    # them, or the global scratch buffer of ceil(B / lanes) blocks of (K+1)
    # W lanes doubles with the tables left in global memory
    tape = jk.JetTape(_arrays(name, K), "cpu")
    B = 10
    lanes, threads, smem, tc, n_it, n_dt = jk._launch_cfg(tape, B, "cpu")
    W = tape.width
    tab = 4 * tape.itab.numel() + 8 * tape.dtab.numel()
    if jk.block_layout(W, K)[1] is None:
        assert (lanes, threads, smem, n_it, n_dt) == (4, 256, 4 * 16 * 8,
                                                       0, 0)
        assert tc.numel() == 3 * (K + 1) * W * 4
    else:
        assert (lanes, threads, tc) == (jk.LANES, jk.THREADS, None)
        assert (n_it, n_dt) == (tape.itab.numel(), tape.dtab.numel())
        assert smem == jk.LANES * 8 * ((K + 1) * W + 16) + tab
        # lanes and threads as chip_smoke.py's sweep asks for them
        assert jk._launch_cfg(tape, B, "cpu", 3, 128)[:3] == (
            3, 128, 3 * 8 * ((K + 1) * W + 16) + tab)
        with pytest.raises(ValueError):
            jk._launch_cfg(tape, B, "cpu", 4, 256)  # 244 KB


@pytest.mark.parametrize("smem,threads,tab,blocks,inside", [
    (61_088, 256, 7_500, 3, True),    # outer SS, one lane: 3 blocks either way
    (183_264, 256, 7_500, 1, True),   # three lanes: one block either way
    (76_000, 256, 1_000, 3, False),   # the tables would cost the third block
    (230_000, 256, 4_000, 1, False),  # past a block's 232,448 B
    (15_808, 256, 2_000, 8, True),    # nbody3: 8 blocks of 256 threads
    (15_808, 128, 2_000, 13, False),  # 16 by threads, 13 -> 12 by bytes
])
def test_tables_join_the_jets_only_where_they_cost_no_block(
        monkeypatch, smem, threads, tab, blocks, inside):
    # an SM's 233,472 B hold blocks of smem + 1,024 B, its 2,048 threads
    # blocks of `threads`
    assert jk.blocks_per_sm(smem, threads) == blocks
    tape = jk.JetTape(_arrays("nbody3", 10), "cpu")
    monkeypatch.setattr(jk, "table_bytes", lambda _: tab)
    assert jk.tables_in_smem(tape, smem, threads) is inside
    assert jk.tables_in_smem(tape, None, threads) is False


@pytest.mark.parametrize("blocks,pad", [(3, 0), (2, 8_213), (1, 47_125)])
def test_jet_scan_padding(blocks, pad):
    # tools.jet_scan pads the outer-SS block (68,588 B with its tables) so
    # that an SM holds 3, 2 or 1 of them
    assert jet_scan.pad_for(blocks, 68_588) == pad
    assert jk.blocks_per_sm(68_588 + pad, jk.THREADS) == blocks


def test_jet_scan_needs_a_card():
    with pytest.raises(RuntimeError):
        jet_scan.run("cpu")
    with pytest.raises(ValueError):
        jet_scan.pad_for(4, 68_588)  # an SM holds 3 at most
