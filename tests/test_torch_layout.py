"""The block shape of kernels B1/B2 (``jet_kernels.block_shape``), which
the wrappers choose from the tape and the lanes of a launch, and the
wrappers' CPU route to the plain twins, on the CPU.  The kernels themselves are held
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


def _hh():
    x, y, px, py = ht.make_vars("x", "y", "px", "py")
    return [(x, px), (y, py), (px, -x - 2.0 * x * y),
            (py, -y - (x * x - y * y))]


def _handbuilt():
    x, y, z = ht.make_vars("x", "y", "z")
    return [
        (x, ht.par[0] * y / (1.0 + x * x) + ht.sqrt(1.5 + y * y)),
        (y, -x / ht.sqrt(x * x + y * y + 0.3) + 0.1 * ht.time_ * z),
        (z, (x * x + z * z + 2.0) ** -1.5 - ht.par[1] * z),
    ]


SYSTEMS = {
    "outer_ss": lambda: nbody(6, masses=MASSES, Gconst=GCONST),
    "hh": _hh,
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
    tape = jk.JetTape(_arrays(name, K), "cpu")
    for B in (1, 10_240):
        sh = jk.launch_shape(tape, B)
        if per > 232_448:  # one lane's block does not fit a block's 227 KB
            assert (sh.layout, sh.lanes, sh.threads, sh.smem, sh.tables) \
                == ("global", jk.GLOBAL_LANES, jk.GLOBAL_THREADS,
                    jk.GLOBAL_LANES * 16 * 8, False)
        else:
            assert sh.layout == "smem" and sh.lanes in jk.LANE_CHOICES
            assert 1 <= sh.lanes <= B and sh.lanes * per <= 232_448
            assert sh.threads == jk.block_threads(tape.pass_rows, sh.lanes)
            assert sh.smem == sh.lanes * per \
                + sh.tables * jk.table_bytes(tape) <= 232_448


@pytest.mark.parametrize("W,K,layout", [
    (1452, 19, "smem"),     # 8 (20 * 1452 + 16) = 232,448 exactly
    (1453, 19, "global"),   # 232,608
    (2640, 10, "smem"),     # 8 (11 * 2640 + 16) = 232,448 exactly
    (2641, 10, "global"),
])
def test_block_layout_at_the_limit(W, K, layout):
    sh = jk.block_shape(W, K, 600, 0, 10_240)
    assert sh.layout == layout
    if layout == "smem":
        assert (sh.lanes, sh.threads, sh.smem, sh.blocks_per_sm) == (
            1, 256, 232_448, 1)


# the rule by hand (132 SMs, an SM's 233,472 B in blocks of smem + 1,024
# B, 2,048 threads, 32 blocks, 65,536 registers at 64 a thread): (tape, B,
# lanes, threads, tables, blocks an SM, waves)
RULE = [
    # 4 rows, 2,848 B a lane, 460 B of tables: 80 lanes an SM in blocks of
    # 16 lanes of 64 threads (the tables would cost the fifth block); 8
    # lanes hold 72 in 9 blocks, 2 waves; one lane of 256 threads held 4
    # (its registers)
    ("hh", 10_240, 16, 64, "global", 5, 1),
    # 135 rows, 61,088 B a lane: 3 lanes an SM in blocks of 1 or 3, the
    # same waves; the fewer lanes a block
    ("outer_ss", 10_240, 1, 256, "smem", 3, 26),
    ("outer_ss", 1, 1, 256, "smem", 3, 1),
    # 27 rows, 15,808 B a lane: 14 lanes an SM in blocks of 2 of 64
    # threads, the most (13 in blocks of 1; the tables would cost a block)
    ("nbody3", 10_240, 2, 64, "global", 7, 6),
    # few lanes: every candidate holds them in one wave
    ("hh", 67, 1, 32, "smem", 32, 1),
    ("hh", 1, 1, 32, "smem", 32, 1),
    ("nbody3", 1, 1, 32, "global", 13, 1),
    # the global layout, unchanged: 4 blocks of 256 threads by registers
    ("mascon128", 10_240, 4, 256, "global", 4, 5),
]


@pytest.mark.parametrize("name,B,lanes,threads,tables,bps,waves", RULE)
def test_block_shape_rule(name, B, lanes, threads, tables, bps, waves):
    tape = jk.JetTape(_arrays(name, 19), "cpu")
    sh = jk.launch_shape(tape, B)
    assert (sh.lanes, sh.threads, "smem" if sh.tables else "global",
            sh.blocks_per_sm, sh.waves) == (lanes, threads, tables, bps,
                                            waves)
    assert sh.lanes_per_sm == lanes * bps
    rep = jk.layout_report(tape, B)
    assert (rep["lanes_per_block"], rep["threads"], rep["tables"],
            rep["blocks_per_sm"], rep["lanes_per_sm"], rep["waves"]) == (
        lanes, threads, tables, bps, lanes * bps, waves)


def test_hh_shape_against_the_fixed_one():
    # the Henon-Heiles tape at the benchmark's 10,240 lanes: at least 8x
    # the lanes an SM of one lane of 256 threads (8 by threads, 4 by
    # registers), in at most 2 waves
    tape = jk.JetTape(_arrays("hh", 19), "cpu")
    assert (tape.width, tape.n_eq, tape.pass_rows) == (17, 4, 4)
    old = jk.launch_shape(tape, 10_240, None, 1, 256)
    assert jk.blocks_per_sm(old.smem, 256) == 8
    assert (old.blocks_per_sm, old.lanes_per_sm, old.waves) == (4, 4, 20)
    new = jk.launch_shape(tape, 10_240)
    assert new.lanes_per_sm >= 8 * old.lanes_per_sm and new.waves <= 2


@pytest.mark.parametrize("lanes,threads", [(5, 64), (64, 256), (2, 96),
                                           (1, 512), (4, 256)])
def test_forced_shapes_outside_the_kernels_raise(lanes, threads):
    # lanes of LANE_CHOICES, threads of BLOCK_THREADS, and lanes whose
    # jets fit a block (4 outer-SS lanes: 244 KB)
    tape = jk.JetTape(_arrays("outer_ss", 19), "cpu")
    with pytest.raises(ValueError):
        jk.launch_shape(tape, 100, None, lanes, threads)


@pytest.mark.parametrize("name,value", [
    ("kSmemMax", jk.SMEM_MAX), ("kLaneScalars", jk.LANE_SCALARS),
    ("kGlobalLanes", jk.GLOBAL_LANES), ("kMaxThreads",
                                        max(*jk.BLOCK_THREADS,
                                            jk.GLOBAL_THREADS))])
def test_constants_match_the_kernel_source(name, value):
    # the Python side counts the same bytes the kernels take
    m = re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text())
    assert m and int(m.group(1)) == value


def test_lane_instances_match_the_kernel_source():
    # an instance of each kernel for each count of LANE_CHOICES
    m = re.search(r"#define HY_LANES\(X\) (.*)", CSRC.read_text())
    assert m and tuple(int(n) for n in re.findall(r"X\((\d+)\)",
                                                  m.group(1))) \
        == jk.LANE_CHOICES


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
    # the shape at the batch's two lanes; the global layout leaves the
    # tables where they are
    sh = jk.launch_shape(ta._jtape, 2)
    per = jk.lane_bytes(ta._jtape.width, ta.order)
    assert rep["layout"] == dict(
        layout=layout, lanes_per_block=sh.lanes,
        smem_bytes=sh.lanes * per if layout == "smem" else None,
        tables="smem" if sh.tables else "global", threads=sh.threads,
        blocks_per_sm=sh.blocks_per_sm, lanes_per_sm=sh.lanes_per_sm,
        waves=sh.waves)
    assert sh.layout == layout
    assert (layout == "smem") == (name != "mascon128")


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
    sh = jk.launch_shape(tape, B)
    if sh.layout == "global":
        assert (lanes, threads, smem, n_it, n_dt) == (4, 256, 4 * 16 * 8,
                                                       0, 0)
        assert tc.numel() == 3 * (K + 1) * W * 4
    else:
        assert (lanes, threads, tc) == (sh.lanes, sh.threads, None) \
            == (1, 256, None)
        assert (n_it, n_dt) == (tape.itab.numel(), tape.dtab.numel())
        assert smem == 8 * ((K + 1) * W + 16) + tab
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
    (15_808, 256, 2_000, 4, True),    # nbody3: 4 blocks by registers
    (15_808, 128, 2_000, 8, True),    # 8 by registers, 13 -> 12 by bytes
    (15_808, 64, 2_000, 13, False),   # 16 by registers, 13 -> 12 by bytes
])
def test_tables_join_the_jets_only_where_they_cost_no_block(
        monkeypatch, smem, threads, tab, blocks, inside):
    # an SM's 233,472 B hold blocks of smem + 1,024 B, its 2,048 threads
    # blocks of `threads`, its 65,536 registers blocks of 64 a thread
    assert jk.blocks_per_sm(smem, threads, jk.REGS) == blocks
    tape = jk.JetTape(_arrays("nbody3", 10), "cpu")
    monkeypatch.setattr(jk, "table_bytes", lambda _: tab)
    assert jk.tables_in_smem(tape, smem, threads) is inside
    assert jk.tables_in_smem(tape, None, threads) is False


@pytest.mark.parametrize("blocks,pad", [(3, 0), (2, 8_213), (1, 47_125)])
def test_jet_scan_padding(blocks, pad):
    # tools.jet_scan pads the outer-SS block (68,588 B with its tables) so
    # that an SM holds 3, 2 or 1 of them
    assert jet_scan.pad_for(blocks, 68_588) == pad
    assert jk.blocks_per_sm(68_588 + pad, jet_scan.THREADS) == blocks


def test_jet_scan_needs_a_card():
    with pytest.raises(RuntimeError):
        jet_scan.run("cpu")
    with pytest.raises(ValueError):
        jet_scan.pad_for(4, 68_588)  # an SM holds 3 at most


class _FakeLib:
    """The kernel library's B1/B2 entries, launching nothing."""

    @staticmethod
    def hy_prop_f64(*args):
        return 0

    @staticmethod
    def hy_jet_f64(*args):
        return 0


@pytest.mark.parametrize("B", [1, 10_240])
def test_shapes_counts_the_launch_engine_report_names(monkeypatch, B):
    # jet_kernels.SHAPES counts each B1/B2 launch under (kernel, lanes,
    # threads, tables): the shape the batch's engine_report names at its
    # lanes (the kernels' entries stubbed, the CPU's SM count)
    monkeypatch.setattr(jk._build, "load", lambda: _FakeLib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    st = np.array([[0.0, 0.1, 0.35, 0.1]] * B)
    ta = ht.taylor_adaptive_batch(_hh(), st, tol=1e-15, device="cpu")
    lay = ta.engine_report()["layout"]
    key = (lay["lanes_per_block"], lay["threads"], lay["tables"])
    tape = ta._jtape
    x = torch.as_tensor(st.T.copy())
    pars = torch.zeros((0, B), dtype=torch.float64)
    aux = torch.ones((5, B), dtype=torch.float64)
    auxi = torch.ones((1, B), dtype=torch.int32)
    before = jk.SHAPES.copy()
    jk._prop_cuda(tape, x, pars, aux, auxi, 4)
    jk._prop_cuda(tape, x, pars, aux, auxi, 4)
    jk._jet_cuda(tape, x, pars)
    got = jk.SHAPES - before
    assert got == {("prop", *key): 2, ("jet", *key): 1}
    assert key == ((16, 64, "global") if B > 1 else (1, 32, "smem"))
