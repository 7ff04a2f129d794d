"""The port's tools (``heyoka_tpu_torch.tools``) against the JAX package's
Pallas tools on the CPU: the convolution microbenchmark (kernel T1's plain
versions against ``tools/microbench_pallas_conv.py``'s kernels in
interpret mode) and the f32 phase prototype (kernel T2's plain body and
buffer against ``tools/proto_pallas_phase.py``'s, run with JAX on the
CPU).  The kernels themselves are held against their plain versions in
tests/test_torch_gpu.py and in chip_smoke.py phases 13 and 14.

Both JAX tools run in f32 with ``jax_enable_x64`` off, as their ``main``
does; the fixtures set the flag and restore it."""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bench
import heyoka_tpu as hy
from heyoka_tpu.expr.decompose import taylor_decompose_sys as j_decompose
from heyoka_tpu.taylor.compact import build_plan as j_build_plan

import heyoka_tpu_torch as ht
from heyoka_tpu_torch import tools
from heyoka_tpu_torch.convert import UnsupportedKernelOp
from heyoka_tpu_torch.expr.decompose import taylor_decompose_sys as p_decompose
from heyoka_tpu_torch.taylor import jet_kernels as jk
from heyoka_tpu_torch.taylor import jet_phase as jp
from heyoka_tpu_torch.taylor.compact import build_plan as p_build_plan
from heyoka_tpu_torch.tools import microbench_conv as mc
from heyoka_tpu_torch.tools import proto_phase as pp
from heyoka_tpu_torch.tools import roofline as rl

#: the small n-body case of the T2 tests: three bodies of the outer Solar
#: System, order 8, the phase from lo = 4, 16 lanes
N3_MASSES = bench.MASSES[:3]
N3_IC = bench.IC[:18]
N3_ORDER, N3_LO, N3_B = 8, 4, 16


@pytest.fixture
def x64_off():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.fixture
def conv_tool(x64_off, monkeypatch):
    """``tools/microbench_pallas_conv.py`` at N = 256 lanes in blocks of
    128 (its import turns x64 off; ``x64_off`` restores the flag)."""
    tool = importlib.import_module("tools.microbench_pallas_conv")
    monkeypatch.setattr(tool, "N", 256)
    monkeypatch.setattr(tool, "NB", 128)
    return tool


@pytest.fixture
def proto_tool(x64_off, monkeypatch):
    """``tools/proto_pallas_phase.py``; its import puts a path of its own at
    the head of ``sys.path``, which is restored afterwards."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    return importlib.import_module("tools.proto_pallas_phase")


def _rel(c, ref):
    """max |c - ref| / max(1, |ref|) (the conv tool's measure)."""
    c, ref = np.asarray(c, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(c - ref) / np.maximum(1.0, np.abs(ref))).max())


# -- T1: the convolution microbenchmark ------------------------------------

def test_conv_f32_plain_matches_pallas(conv_tool):
    # the same arithmetic in the same order, f32 in both: 1e-6 relative
    a64, b64, _ = mc.inputs(conv_tool.N, seed=0)
    with pltpu.force_tpu_interpret_mode():
        c = conv_tool.conv_pallas_f32(jnp.asarray(a64, jnp.float32),
                                      jnp.asarray(b64, jnp.float32))
    before = dict(jk.LAUNCHES)
    p = mc.conv_f32(torch.as_tensor(a64).float(), torch.as_tensor(b64).float())
    assert jk.LAUNCHES == before  # the plain version on the CPU
    assert p.dtype == torch.float32 and p.shape == (mc.K, conv_tool.N)
    assert _rel(p.numpy(), c) <= 1e-6


def test_conv_dd_plain_matches_tool_body(conv_tool):
    # the tool's kernel body (conv_kernel_dd) run eagerly, op by op, on the
    # same pairs: hi + lo in f64 to 1e-12
    _, _, dd = mc.inputs(conv_tool.N, seed=0)
    out = [np.zeros((mc.K, conv_tool.N), np.float32) for _ in range(2)]
    conv_tool.conv_kernel_dd(*(jnp.asarray(x) for x in dd), *out)
    phi, plo = mc.conv_dd(*(torch.as_tensor(x) for x in dd))
    got = phi.double() + plo.double()
    assert _rel(got.numpy(), out[0].astype(np.float64) + out[1]) <= 1e-12


def test_conv_dd_plain_matches_pallas(conv_tool):
    # conv_pallas_dd in interpret mode: XLA:CPU compiles the kernel into
    # fused loops that do not keep the two-f32 error terms, so its hi + lo
    # lies ~2e-7 from the f64 convolution on these inputs (the body run
    # eagerly: ~1e-13).  The port is held to it at f32's 1e-6, and to the
    # f64 reference, which the interpret-mode pair misses, at 1e-12.
    a64, b64, dd = mc.inputs(conv_tool.N, seed=0)
    with pltpu.force_tpu_interpret_mode():
        hi, lo = conv_tool.conv_pallas_dd(*(jnp.asarray(x) for x in dd))
    ref = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    phi, plo = mc.conv_dd(*(torch.as_tensor(x) for x in dd))
    got = (phi.double() + plo.double()).numpy()
    assert _rel(got, ref) <= 1e-6
    c64 = mc.conv_f64(torch.as_tensor(a64), torch.as_tensor(b64)).numpy()
    assert _rel(got, c64) <= 1e-12


def test_conv_plain_versions_against_f64():
    # the tool's accuracy report: f32 ~1e-6 over 20-term sums, two-f32 at
    # ~2^-48; the library call (grouped conv1d, f32 on the CPU) agrees with
    # the f32 version to f32 rounding
    a64, b64, dd = mc.inputs(64, seed=3)
    a, b = torch.as_tensor(a64), torch.as_tensor(b64)
    c64 = mc.conv_f64(a, b)
    np.testing.assert_allclose(
        c64.numpy()[5], sum(a64[j] * b64[5 - j] for j in range(6)),
        rtol=1e-15)
    c32 = mc.conv_f32_plain(a.float(), b.float())
    hi, lo = mc.conv_dd_plain(*(torch.as_tensor(x) for x in dd))
    assert mc.rel_err(c32, c64) <= 5e-6
    assert mc.rel_err(hi.double() + lo.double(), c64) <= 1e-12
    assert mc.rel_err(mc.conv_library(a.float(), b.float())()[0].t(),
                      c32) <= 5e-6


# -- T2: the f32 phase prototype -------------------------------------------

def _n3(pkg):
    return pkg.models.nbody(3, masses=N3_MASSES, Gconst=bench.GCONST)


def _plans(order=N3_ORDER):
    return (j_build_plan(j_decompose(_n3(hy)), order),
            p_build_plan(p_decompose(_n3(ht)), order))


def _per_order(a, b):
    return pp.per_order_rel(torch.as_tensor(np.array(a)),
                            torch.as_tensor(np.array(b))).numpy()


def test_phase_body_plain_matches_prototype(proto_tool):
    # the prototype's body (jnp, f32, jit on the CPU) and the port's on the
    # same buffer, each with its own package's plan; the orders below lo
    # pass through, the rest agree to 1e-5 of each order's largest
    # magnitude: XLA:CPU compiles the body into fused loops that round the
    # f32 sums otherwise than the eager torch ops (up to ~6e-7 at order 8)
    j_plan, p_plan = _plans()
    tc = pp.realistic_buffer(p_plan, N3_IC, N3_B, N3_LO, "cpu", seed=5)
    body = proto_tool.build_phase_body(j_plan, N3_LO, N3_ORDER, j_plan.n_eq)
    ref = np.asarray(jax.jit(body)(jnp.asarray(tc.numpy())))
    got = pp.phase_body_plain(p_plan, N3_LO, N3_ORDER, p_plan.n_eq)(tc)
    assert got.dtype == torch.float32 and got.shape == tc.shape
    assert torch.equal(got[:, :N3_LO], tc[:, :N3_LO])
    rel = _per_order(got.numpy(), ref)
    assert rel.max() <= 1e-5, rel


def test_realistic_buffer_matches_prototype(proto_tool):
    # main()'s buffer (:114-137) built as the prototype builds it, with its
    # own body for orders 1..lo-1, against the port's realistic_buffer:
    # order 0 (numpy in both) equal, the low orders to 1e-5 of each
    # order's largest magnitude, as above
    j_plan, p_plan = _plans()
    W, n_eq, K = j_plan.width, j_plan.n_eq, j_plan.order
    rng = np.random.default_rng(0)
    states = (N3_IC[None, :] + np.abs(N3_IC)[None, :]
              * (rng.uniform(-1, 1, (N3_B, N3_IC.size)) * 1e-8)
              ).astype(np.float32)
    tc0 = np.zeros((W, K + 1, N3_B), np.float32)
    tc0[:n_eq, 0, :] = states.T
    for ci, cv in j_plan.const_cols:
        tc0[ci, 0, :] = cv
    row0 = tc0[:, 0, :]
    for lv in j_plan.levels:
        for g in lv:
            if g.name == "sum":
                vals = row0[g.in_cols].sum(axis=1)
            elif g.name == "mul":
                vals = row0[g.in_cols[:, 0]] * row0[g.in_cols[:, 1]]
            else:
                vals = row0[g.in_cols[:, 0]] ** g.alpha[:, None]
            row0[g.out_start:g.out_start + g.out_cols.size] = vals
    low = proto_tool.build_phase_body(j_plan, 1, N3_LO - 1, n_eq)
    ref = np.asarray(jax.jit(low)(jnp.asarray(tc0)))
    got = pp.realistic_buffer(p_plan, N3_IC, N3_B, N3_LO, "cpu").numpy()
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    assert (got[:, N3_LO:] == 0).all()
    assert _per_order(got, ref)[1:N3_LO].max() <= 1e-5


def test_phase_body_mixed_exponents_against_f64():
    # one pow group with exponents -1.5 and 2.5 (the prototype allows one
    # per group; the port's body and kernel read each column's): the f32
    # orders against phase_plain's f64 ones on the same lower orders,
    # 1e-5 of each order's largest magnitude
    x, y = ht.make_vars("x", "y")
    sys_ = [(x, y * (x * x + y * y + 2.0) ** -1.5),
            (y, -x + 0.01 * (x * x + y * y + 1.0) ** 2.5)]
    plan = p_build_plan(p_decompose(sys_), 12)
    assert any(g.name == "pow" and np.unique(g.alpha).size == 2
               for lv in plan.levels for g in lv)
    tc = pp.realistic_buffer(plan, np.array([0.6, -0.4]), 32, 5, "cpu")
    got = pp.phase_body_plain(plan, 5, 12, plan.n_eq)(tc)
    tc64 = tc.double().permute(1, 0, 2).contiguous()
    jp.phase_plain(jp.PhaseTape(ht.plan_to_arrays(plan), "cpu"), tc64, 5)
    rel = pp.per_order_rel(got, tc64.permute(1, 0, 2))
    assert float(rel.max()) <= 1e-5, rel


def test_phase_f32_on_cpu_runs_the_body_in_place():
    # the wrapper takes B4's (K+1, W, B) buffer and runs the plain body on
    # the prototype's view of it
    plan = p_build_plan(p_decompose(_n3(ht)), N3_ORDER)
    tape = pp.ProtoTape(ht.plan_to_arrays(plan), "cpu")
    tc = pp.realistic_buffer(plan, N3_IC, N3_B, N3_LO, "cpu")
    ref = pp.phase_body_plain(plan, N3_LO, N3_ORDER, plan.n_eq)(tc)
    kwb = tc.permute(1, 0, 2).contiguous()
    before = dict(jk.LAUNCHES)
    out = pp.phase_f32(tape, kwb, N3_LO)
    assert jk.LAUNCHES == before
    assert out is kwb and torch.equal(kwb.permute(1, 0, 2), ref)
    with pytest.raises(ValueError):
        pp.phase_f32(tape, kwb, 0)


def test_proto_rule_set():
    # the tables and the body take sum, mul and pow only
    plan = p_build_plan(p_decompose(ht.models.pendulum()), 8)
    with pytest.raises(UnsupportedKernelOp):
        pp.ProtoTape(ht.plan_to_arrays(plan), "cpu")
    with pytest.raises(NotImplementedError):
        pp.phase_body_plain(plan, 1, 8, plan.n_eq)


# -- the constants and the bounds --------------------------------------------

def test_constants_equal_bench():
    assert tools.MASSES == bench.MASSES
    assert tools.GCONST == bench.GCONST
    np.testing.assert_array_equal(tools.IC, bench.IC)


def test_outer_ss_plan_counts():
    # the north-star tape the bounds are reckoned on: 36 state rows, 240
    # mul, 15 pow (alpha = -1.5) and 78 sum columns, 12 constants (the
    # zero column among them), W = 381
    plan = pp.outer_ss_plan()
    arrays = ht.plan_to_arrays(plan)
    ops = [op for op, _ in rl.op_columns(arrays)]
    assert (plan.width, plan.n_eq, len(plan.const_cols)) == (381, 36, 12)
    assert {op: ops.count(op) for op in set(ops)} == dict(
        mul=240, pow=15, sum=78)
    assert set(arrays["alpha"][arrays["alpha"] != 0]) == {-1.5}
    # T2: about 0.88 GFLOP over 0.48 GB at B = 10,240: bound by bytes
    fl = rl.phase_flops(arrays, pp.LO) * pp.B
    by = rl.phase_bytes(arrays, pp.B, pp.LO, 4)
    assert 0.85e9 < fl < 0.9e9 and by == 4 * pp.B * (381 * 20 + 369 * 11)
    assert rl.bound(fl, by, torch.float32)["bound_by"] == "bytes"


def test_roofline_counts():
    # a mul column at order k does k+1 products and k adds (the sum starts
    # at its first product); each state row one divide an order; the jet
    # adds one operation per op column at order 0; the bound is the larger
    # time
    x, y = ht.make_vars("x", "y")
    arrays = ht.plan_to_arrays(p_build_plan(p_decompose([(x, x * y),
                                                         (y, x)]), 4))
    assert [op for op, _ in rl.op_columns(arrays)] == ["mul"]
    assert rl.phase_flops(arrays, 1) == 2 * 4 + sum(2 * k + 1
                                                    for k in range(1, 5))
    assert rl.jet_flops(arrays) == rl.phase_flops(arrays, 1) + 1
    b = rl.bound(67e12, 3.35e12 * 2, torch.float32)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(2e3)
    b = rl.bound(68e12, 0, torch.float64)
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(
        2e3)
    assert mc.flops(10) == dict(f32=4000, dd=(21 * 210 + 120) * 10)


# each rule at order k counted by hand from its recurrence (the comment of
# its case in csrc/taylor_phase.cu phase_k): the products of its sums, the
# adds between their terms, and the outer operations
@pytest.mark.parametrize("op, k, count", [
    ("mul", 3, 4 + 3),            # a_0 b_3 + ... + a_3 b_0
    ("div", 3, 3 + 2 + 2),        # (a_3 - (q_0 b_3 + q_1 b_2 + q_2 b_1)) / b_0
    ("sqrt", 1, 2),               # a_1 / (2 q_0)
    ("sqrt", 3, 2 + 1 + 3),       # (a_3 - (q_1 q_2 + q_2 q_1)) / (2 q_0)
    ("pow", 1, 2 + 2),            # (w q_0 b_1) / (1 b_0)
    ("pow", 3, 6 + 2 + 2),        # (sum of 3 weighted products) / (3 b_0)
    ("exp", 3, 6 + 2 + 1),        # (sum_{j=1..3} (j b_j) e_{3-j}) / 3
    ("cos", 2, 4 + 1 + 1),        # the negation costs nothing
    ("log", 1, 1),                # b_1 / b_0
    ("log", 3, 4 + 1 + 3),        # (b_3 - (2 weighted products) / 3) / b_0
    ("acos", 3, 4 + 1 + 3),
    ("tan", 3, 6 + 2 + 2),        # b_3 + (sum of 3) / 3
    ("erf", 3, 6 + 2 + 2),        # c ((sum of 3) / 3)
    ("sigmoid", 3, 9 + 2 + 1),    # ((k-m) (s_m - q_m)) b_{k-m}, over 3
    ("atan2", 1, 2 + 2 + 3),
    ("atan2", 3, 8 + 8 + 5 + 4),  # r1, r2, s; r1 - r2, - s, k d_0, divide
    ("kepE", 1, 1 + 2 + 1 + 3),
    ("kepE", 3, 1 + 8 + 5 + 2 + 3),
    ("kepF", 1, 1 + 2 + 2 + 2 + 3),
    ("kepF", 3, 1 + 8 + 8 + 5 + 3 + 3),
    ("kepDE", 1, 4 + 2 + 2 + 3),
    ("kepDE", 3, 4 + 5 + 8 + 5 + 4 + 3),
])
def test_order_k_counts(op, k, count):
    assert rl._ORDER_K[op](k, 1) == count
