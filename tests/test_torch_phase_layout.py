"""The block engine of kernels B4 and T2 (csrc/phase_block.cuh) on the CPU:
the block-shape rule at its edges, the packed level table, the soundness
of one pass per level, and a Python walk of the packed tables in the
kernels' pass and term order, equal bit for bit to the plain twins.  The
kernels themselves are held to these on the card (tests/test_torch_gpu.py,
chip_smoke.py phases 10, 12 and 14, tools/same_bits.py)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.taylor import jet_phase as jp
from heyoka_tpu_torch.taylor.compact import build_plan
from heyoka_tpu_torch.tools import proto_phase as pp

from chip_smoke import phase_cases, phase_lanes, seeded_buffer

CASES = phase_cases(ht)
_F64, _F32 = torch.float64, torch.float32


def _plan(name, order):
    return build_plan(ht.taylor_decompose_sys(CASES[name][0]), order)


def _tape(name, order=19):
    return jp.PhaseTape(ht.plan_to_arrays(_plan(name, order)), "cpu")


def _ss(cls, order=19):
    return cls(ht.plan_to_arrays(pp.outer_ss_plan(order)), "cpu")


def _wide_tape():
    # 13 bodies: 1,481 columns, 236,960 B a lane at K = 19 in f64, over
    # the 232,448 B of a block (118,480 B in f32)
    return jp.PhaseTape(ht.plan_to_arrays(build_plan(ht.taylor_decompose_sys(
        ht.models.nbody(13)), 19)), "cpu")


# -- the block shape -------------------------------------------------------------

@pytest.mark.parametrize("case,B,itemsize,shape", [
    # one lane-jet is 1,120 B: 32 lanes a block, all in shared memory
    ("pendulum", 10_240, 8, ("smem", 32, 128)),
    # the widest mixed tape (5,600 B a lane): 32 lanes a block too, though
    # 1,024 lanes then make 32 blocks for 132 SMs
    ("hyper", 1_024, 8, ("smem", 32, 256)),
    # a block holds three lanes (60,960 B each), a row of 24 B: the global
    # layout, 32 lanes a block, whatever B
    ("outer_ss", 10_240, 8, ("global", 32, 256)),
    ("outer_ss", 2_048, 8, ("global", 32, 256)),
    # f32: seven lanes, a row of 28 B: global as well
    ("outer_ss", 10_240, 4, ("global", 32, 256)),
    ("outer_ss", 100, 4, ("global", 32, 256)),
    # fewer lanes than a block would take: one block of them
    ("pendulum", 5, 8, ("smem", 5, 32)),
    ("hyper", 20, 8, ("smem", 20, 256)),
])
def test_block_shape_at_the_edges(case, B, itemsize, shape):
    tape = _ss(pp.ProtoTape if itemsize == 4 else jp.PhaseTape) \
        if case == "outer_ss" else _tape(case)
    sh = jp.block_shape(tape, B, itemsize)
    assert (sh.layout, sh.lanes, sh.threads) == shape
    per = jp.lane_bytes(tape, itemsize) if sh.layout == "smem" else 0
    assert sh.smem - sh.lanes * per in (0, jp.table_bytes(tape))
    assert sh.smem <= jp.SMEM_MAX and sh.lanes <= jp.MAX_LANES
    # the smem layout only where a row of the lanes a block holds fills a
    # sector of global memory
    fits = min(jp.MAX_LANES, jp.SMEM_MAX // jp.lane_bytes(tape, itemsize))
    assert (sh.layout == "smem") == (fits * itemsize >= jp.SECTOR)


def test_block_shape_goes_global_past_the_shared_memory():
    tape = _wide_tape()
    assert jp.lane_bytes(tape, 8) > jp.SMEM_MAX >= jp.lane_bytes(tape, 4)
    sh = jp.block_shape(tape, 10_240, 8)
    assert sh.layout == "global"
    assert sh.lanes == jp.MAX_LANES and sh.threads == 256
    # in place in the caller's buffer: only the tables in shared memory
    assert sh.smem in (0, jp.table_bytes(tape))
    # in f32 a lane fits a block, a row of 4 B: global too, and the smem
    # layout only when forced
    assert jp.block_shape(tape, 10_240, 4).layout == "global"
    assert jp.block_shape(tape, 10_240, 4, layout="smem").lanes == 1
    with pytest.raises(ValueError):
        jp.block_shape(tape, 10_240, 8, layout="smem")


def test_forced_shapes_and_their_limits():
    tape = _tape("hyper")
    for lanes in (1, 3, 32):
        for nt in jp.BLOCK_THREADS:
            for lay in ("smem", "global"):
                sh = jp.block_shape(tape, 1_024, 8, lanes, nt, lay)
                assert (sh.layout, sh.lanes, sh.threads) == (lay, lanes, nt)
    for bad in (dict(threads=48), dict(lanes=0), dict(layout="tmem")):
        with pytest.raises(ValueError):
            jp.block_shape(tape, 1_024, 8, **bad)
    with pytest.raises(ValueError):  # 1,024 lanes of 5,600 B
        jp.block_shape(tape, 1_024, 8, lanes=1_024)
    # every shape the sweeps force is one the rule accepts
    for itemsize in (8, 4):
        shapes = jp.sweep_shapes(tape, itemsize)
        assert len(shapes) == len(set(shapes)) == 2 * 6 * 4
        for lay, L, nt in shapes:
            assert jp.block_shape(tape, 1_024, itemsize, L, nt, lay).lanes == L


# -- the level table and one pass per level ------------------------------------------

def _hdr(tape):
    it = tape.itab.tolist()
    return it, dict(zip(jp._PHDR, it[:len(jp._PHDR)]))


def _levels_of(plan):
    return [sorted(int(c) for g in lv for c in np.asarray(g.out_cols))
            for lv in plan.levels if len(lv)]


@pytest.mark.parametrize("name", list(CASES) + ["outer_ss", "outer_ss_f32"])
def test_packed_levels_equal_the_plan(name):
    if name.startswith("outer_ss"):
        plan = pp.outer_ss_plan()
        cls = pp.ProtoTape if name.endswith("f32") else jp.PhaseTape
        tape = cls(ht.plan_to_arrays(plan), "cpu")
    else:
        plan, tape = _plan(name, 19), _tape(name)
    it, h = _hdr(tape)
    lvl = it[h["lvl"]:h["lvl"] + h["n_lv"] + 1]
    levels = _levels_of(plan)
    assert h["n_lv"] == len(levels) == tape.lvl.size - 1
    assert lvl == tape.lvl.tolist()
    for v, cols in enumerate(levels):
        assert cols == list(range(lvl[v], lvl[v + 1]))
    assert lvl[-1] == tape.n_eq + tape.arrays["arg_ptr"].size - 1
    # the opcode of every op column, in its group's order
    cop = it[h["cop"]:h["cop"] + lvl[-1] - tape.n_eq]
    for g in (g for lv in plan.levels for g in lv):
        assert all(cop[c - tape.n_eq] == ht.OPCODES.index(g.name)
                   for c in np.asarray(g.out_cols))


@pytest.mark.parametrize("name", list(CASES) + ["outer_ss"])
def test_no_item_reads_its_own_level_at_its_order(name):
    # what one pass per level needs: at order k an item reads its
    # operands' order k, and no operand is written in the item's pass
    tape = _ss(jp.PhaseTape) if name == "outer_ss" else _tape(name)
    a, lvl = tape.arrays, tape.lvl
    n_eq = tape.n_eq
    for v in range(lvl.size - 1):
        own = set(range(lvl[v], lvl[v + 1]))
        for c in own:
            ops = a["args"][a["arg_ptr"][c - n_eq]:a["arg_ptr"][c - n_eq + 1]]
            assert not (set(ops.tolist()) - {c}) & own, (name, c)
    jp.check_levels(a, lvl)


def test_check_levels_refuses_a_merged_level():
    # the pendulum's [sin, cos] and [mul] as one pass: mul reads sin
    tape = _tape("pendulum")
    merged = np.delete(tape.lvl, 1)
    with pytest.raises(ValueError, match="reads a column of level"):
        jp.check_levels(tape.arrays, merged)


# -- the walk of the packed tables ------------------------------------------------------

def _tables(tape):
    it, h = _hdr(tape)
    dt = tape.dtab.tolist()
    n_lv = h["n_lv"]
    lvl = it[h["lvl"]:h["lvl"] + n_lv + 1]
    n_ops = lvl[-1] - h["n_eq"]

    def sub(key, n):
        return it[h[key]:h[key] + n]
    return SimpleNamespace(
        n_eq=h["n_eq"], K=h["K"], n_syn=h["n_syn"], lvl=lvl,
        rhs=sub("rhs", h["n_eq"]), argptr=sub("argptr", n_ops + 1),
        args=it[h["args"]:], cop=sub("cop", n_ops), aux=sub("aux", 2 * n_ops),
        syn=sub("syn", n_ops), sync=sub("syncol", h["n_syn"]),
        alpha=dt[h["d_alpha"]:])


_OP = {name: i for i, name in enumerate(ht.OPCODES)}
_TWO_SQRTPI = 2.0 / np.sqrt(np.pi)


def _acc(terms, like):
    """``s = 0.0; s += t`` for each term in turn, as the kernels add."""
    s = torch.zeros_like(like)
    for t in terms:
        s = s + t
    return s


def _b4_item(T, L, S, c, k, Q=None):
    """csrc/taylor_phase.cu ``phase_k``: order k of column c, L(k, c) and
    S(j, row) the lanes' coefficients and synthetic rows, Q(k, row) their
    side rows (the dense series, the interpolants' slopes)."""
    o = c - T.n_eq
    op = ht.OPCODES[T.cop[o]]
    a = T.args[T.argptr[o]:T.argptr[o + 1]]
    x = T.aux[2 * o:2 * o + 2]
    z = L(0, c)

    def up(p, q, j0, j1):  # sum_{j=j0..j1} (j p_j) q_{k-j}
        return _acc(((float(j) * L(j, p)) * L(k - j, q)
                     for j in range(j0, j1 + 1)), z)

    def dn(p, q, m0):  # sum_{m=m0..k-1} ((k-m) p_m) q_{k-m}
        return _acc(((float(k - m) * L(m, p)) * L(k - m, q)
                     for m in range(m0, k)), z)

    def syn_conv(row):
        return _acc(((float(k - m) * S(m, row)) * L(k - m, c)
                     for m in range(1, k)), z)

    if op == "sum":
        return _sum_in_order([L(k, q) for q in a])
    if op == "mul":
        return _acc((L(j, a[0]) * L(k - j, a[1]) for j in range(k + 1)), z)
    if op == "div":
        s = _acc((L(j, c) * L(k - j, a[1]) for j in range(k)), z)
        return (L(k, a[0]) - s) / L(0, a[1])
    if op == "sqrt":
        s = _acc((L(j, c) * L(k - j, c) for j in range(1, k)), z)
        return (L(k, a[0]) - s) / (2.0 * L(0, c))
    if op == "pow":
        s1 = _acc(((L(j, c) * L(k - j, a[0])) * float(k - j)
                   for j in range(k)), z)
        s2 = _acc(((float(j) * L(j, c)) * L(k - j, a[0])
                   for j in range(k)), z)
        return (s1 * T.alpha[o] - s2) / (float(k) * L(0, a[0]))
    if op == "exp":
        return up(a[0], c, 1, k) / float(k)
    if op in ("sin", "sinh", "cosh"):
        return up(a[0], x[0], 1, k) / float(k)
    if op == "cos":
        return -(up(a[0], x[0], 1, k) / float(k))
    if op == "log":
        return (L(k, a[0]) - up(c, a[0], 1, k - 1) / float(k)) / L(0, a[0])
    if op == "tan":
        return L(k, a[0]) + dn(x[0], a[0], 0) / float(k)
    if op == "tanh":
        return L(k, a[0]) - dn(x[0], a[0], 0) / float(k)
    if op == "sigmoid":
        return _acc(((float(k - m) * (L(m, c) - L(m, x[0]))) * L(k - m, a[0])
                     for m in range(k)), z) / float(k)
    if op in ("asin", "acos", "atan", "atanh", "asinh", "acosh"):
        bk = L(k, a[0])
        return ((-bk if op == "acos" else bk) - dn(a[1], c, 1) / float(k)) \
            / L(0, a[1])
    if op == "erf":
        return _TWO_SQRTPI * (dn(a[1], a[0], 0) / float(k))
    if op == "atan2":
        r1 = _acc((float(k - m) * (L(m, a[1]) * L(k - m, a[0]))
                   for m in range(k)), z)
        r2 = _acc((float(k - m) * (L(m, a[0]) * L(k - m, a[1]))
                   for m in range(k)), z)
        s = _acc((float(k - m) * (L(m, a[2]) * L(k - m, c))
                  for m in range(1, k)), z)
        return ((r1 - r2) - s) / (float(k) * L(0, a[2]))
    if op in ("kepE", "kepF", "kepDE"):
        row, kf = T.syn[o], float(k)
        if op == "kepE":
            t = (kf * L(k, a[1]) + up(a[0], x[0], 1, k)) + syn_conv(row)
            return t / (kf * (1.0 - S(0, row)))
        if op == "kepF":
            t = ((kf * L(k, a[2]) - up(a[0], x[1], 1, k))
                 + up(a[1], x[0], 1, k)) + syn_conv(row)
            return t / (kf * (1.0 - S(0, row)))
        t = (((kf * L(k, a[2]) - (kf * L(k, a[0])) * (1.0 - L(0, x[1])))
              + up(a[0], x[1], 1, k - 1)) + up(a[1], x[0], 1, k)) \
            - syn_conv(row)
        return t / (kf * (1.0 + S(0, row)))
    if op == "relu":
        return torch.where(L(0, a[0]) > 0.0, L(k, a[0]), torch.zeros_like(z))
    if op == "select":
        return torch.where(L(0, a[0]) != 0.0, L(k, a[1]), L(k, a[2]))
    if op == "trigseries":
        return Q(k, T.syn[o])
    if op == "interp":
        return Q(0, T.syn[o]) * L(k, a[0])
    if op == "dayfrac":
        return L(k, a[0])
    # relup, the relational and logical ops, interp_p
    return torch.zeros_like(z)


def _sum_in_order(vals):
    v = vals[0]
    for w in vals[1:]:
        v = v + w
    return v


def _b4_synth(T, L, o, j):
    """csrc/taylor_phase.cu ``synth_j``: order j of Kepler column o's
    synthetic row."""
    op = ht.OPCODES[T.cop[o]]
    a = T.args[T.argptr[o]:T.argptr[o + 1]]
    x = T.aux[2 * o:2 * o + 2]
    z = L(0, a[0])

    def cv(p, q):
        return _acc((L(i, p) * L(j - i, q) for i in range(j + 1)), z)
    if op == "kepE":
        return cv(a[0], x[1])
    s1, s2 = cv(a[0], x[0]), cv(a[1], x[1])
    return s1 + s2 if op == "kepF" else s1 - s2


def _t2_item(T, L, S, c, k):
    """csrc/proto_phase.cu ``T2Rule::order_k`` in f32."""
    o = c - T.n_eq
    op = ht.OPCODES[T.cop[o]]
    a = T.args[T.argptr[o]:T.argptr[o + 1]]
    if op == "sum":
        return _sum_in_order([L(k, q) for q in a])
    if op == "mul":
        v = L(0, a[0]) * L(k, a[1])
        for j in range(1, k + 1):
            v = v + L(j, a[0]) * L(k - j, a[1])
        return v
    assert op == "pow"
    al = T.alpha[o]
    v = (L(0, c) * L(k, a[0])) * float(np.float32(al * k))
    for j in range(1, k):
        v = v + (L(j, c) * L(k - j, a[0])) * float(np.float32(al * (k - j)
                                                               - j))
    return v / (float(k) * L(0, a[0]))


def _walk(tape, tc, lo, item, synth=None, side=None):
    """Orders lo..K of ``tc (K+1, W, B)`` in place by the packed tables, as
    a block of the engine runs them: a pass for the synthetic rows below
    lo and the state rows of order lo, then per order one pass per level
    and one for the synthetic rows of the order with the state rows of the
    next.  A pass computes all its items from what the earlier passes
    wrote, then stores them.  ``side``: ``order0``'s side rows, which the
    items read as ``Q``."""
    T = _tables(tape)
    K = T.K
    S = tc.new_zeros((K + 1, T.n_syn, tc.shape[-1]))

    def L(k, c):
        return tc[k, c]

    def Sr(j, r):
        return S[j, r]

    def tail(j0, j1, ks):
        for j in range(j0, j1):
            for r, o in enumerate(T.sync):
                S[j, r] = synth(T, L, o, j)
        vals = [tc[ks - 1, T.rhs[s]] / float(ks) for s in range(T.n_eq)]
        for s, v in enumerate(vals):
            tc[ks, s] = v

    tail(0, lo, lo)
    for k in range(lo, K + 1):
        for v in range(len(T.lvl) - 1):
            cols = range(T.lvl[v], T.lvl[v + 1])
            vals = [item(T, L, Sr, c, k) if side is None else
                    item(T, L, Sr, c, k, Q=lambda j, r: side[j, r])
                    for c in cols]
            for c, val in zip(cols, vals):
                tc[k, c] = val
        if k < K:
            tail(k, k + 1, k + 1)
    return tc


def _conv_in_order(w, A, Bf):
    return _acc(((w[j] * A[j]) * Bf[j] for j in range(A.shape[0])),
                torch.zeros(A.shape[1:], dtype=A.dtype))


def _eval_k_in_order(name, alpha, k, hist, nargs):
    """``jet_kernels._eval_k`` with its sums run one add at a time."""
    if name == "sum":
        return _sum_in_order([hist(q, k, k + 1)[0] for q in range(nargs)])
    A = hist(0, 0, k + 1)
    if name == "mul":
        B_ = hist(1, 0, k + 1)
        return _acc((A[j] * B_[k - j] for j in range(k + 1)), A[0])
    Q = hist(-1, 0, k + 1)
    if name == "div":
        B_ = hist(1, 0, k + 1)
        s = _acc((Q[j] * B_[k - j] for j in range(k)), A[0])
        return (A[k] - s) / B_[0]
    if name == "sqrt":
        s = _acc((Q[j] * Q[k - j] for j in range(1, k)), A[0])
        return (A[k] - s) / (2.0 * Q[0])
    s1 = _acc(((Q[j] * A[k - j]) * float(k - j) for j in range(k)), A[0])
    s2 = _acc(((float(j) * Q[j]) * A[k - j] for j in range(k)), A[0])
    al = torch.as_tensor(alpha, device=Q.device)[:, None]
    return (s1 * al - s2) / (k * A[0])


def _twin_in_kernel_order(monkeypatch):
    """Swap the twin's torch reductions for sums in the kernel's order: its
    products and expressions stay its own."""
    orig = jp._phase_k

    def phase_k(name, alpha, k, hist, nargs, dev):
        if name != "atan2":
            return orig(name, alpha, k, hist, nargs, dev)
        Y, X = hist(0, 0, k + 1), hist(1, 0, k + 1)
        D, A = hist(2, 0, k), hist(-1, 0, k)
        r1 = _acc((float(k - m) * (X[m] * Y[k - m]) for m in range(k)), Y[0])
        r2 = _acc((float(k - m) * (Y[m] * X[k - m]) for m in range(k)), Y[0])
        s = _acc((float(k - m) * (D[m] * A[k - m]) for m in range(1, k)),
                 Y[0])
        return ((r1 - r2) - s) / (k * D[0])

    def synth_j(name, j, hist):
        def cv(q, aux):
            P, R = hist(q, 0, j + 1), hist(aux, 0, j + 1)
            return _acc((P[i] * R[j - i] for i in range(j + 1)), P[0])
        if name == "kepE":
            return cv(0, "cos")
        if name == "kepF":
            return cv(0, "sin") + cv(1, "cos")
        return cv(0, "sin") - cv(1, "cos")

    monkeypatch.setattr(jp, "_conv", _conv_in_order)
    monkeypatch.setattr(jp, "_eval_k", _eval_k_in_order)
    monkeypatch.setattr(jp, "_phase_k", phase_k)
    monkeypatch.setattr(jp, "_synth_j", synth_j)


@pytest.mark.parametrize("name", list(CASES))
def test_tables_walk_to_the_twin(monkeypatch, name):
    # the walk reads only the packed tables; the twin only the plan's
    # groups: equal bit for bit from lo = 1 and lo = 9, once the twin sums
    # in the kernel's order (and within 1e-13 of the twin as it is)
    K, B = 12, 6
    tape = _tape(name, K)
    st0, pars = CASES[name][1:]
    tc0 = seeded_buffer(tape, *phase_lanes(st0, pars, B, 9), "cpu")
    ref_torch = jp.phase_plain(tape, tc0.clone(), 1)
    _twin_in_kernel_order(monkeypatch)
    ref = jp.phase_plain(tape, tc0.clone(), 1)
    got = _walk(tape, tc0.clone(), 1, _b4_item, _b4_synth)
    assert torch.equal(got, ref)
    scale = ref_torch.abs().amax(dim=(1, 2)).clamp_min(1e-300)
    assert float(((got - ref_torch).abs().amax(dim=(1, 2))
                  / scale).max()) <= 1e-13
    n_w = int(tape.lvl[-1])
    tc9 = ref.clone()
    tc9[9:, :n_w] = float("nan")
    assert torch.equal(_walk(tape, tc9, 9, _b4_item, _b4_synth), ref)


@pytest.mark.parametrize("order,lo,n_lanes", [(12, 5, 4), (19, 9, 3)])
def test_t2_walk_equals_the_plain_body(order, lo, n_lanes):
    # kernel T2's rules by the packed tables, against the prototype's plain
    # body (which adds in the kernel's order already), bit for bit
    plan = pp.outer_ss_plan(order)
    tape = pp.ProtoTape(ht.plan_to_arrays(plan), "cpu")
    tc = pp.realistic_buffer(plan, pp.IC, n_lanes, lo, "cpu", seed=5)
    ref = pp.phase_body_plain(plan, lo, order, plan.n_eq)(tc.clone())
    got = _walk(tape, tc.permute(1, 0, 2).contiguous(), lo, _t2_item)
    assert got.dtype == _F32
    assert torch.equal(got.permute(1, 0, 2), ref)


@pytest.mark.parametrize("lo", [1, 9])
def test_tables_walk_to_the_twin_with_interpolants(lo):
    # the data-driven ops (tools/cases.py eop_ode_sys): an interpolant's
    # order k is its side row's slope times its input's order k, its
    # slope's zero, dayfrac's its input's; the walk by the packed tables
    # equals the twin bit for bit
    from heyoka_tpu_torch.tools.cases import eop_ode_sys

    K, B = 12, 5
    tape = jp.PhaseTape(ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(eop_ode_sys(ht)), K)), "cpu")
    rng = np.random.default_rng(4)
    tc0 = seeded_buffer(tape, rng.uniform(-1, 1, (B, 2)), np.zeros((B, 0)),
                        5478.0 + rng.uniform(0, 900, B), "cpu")
    side = jp.order0(tape, tc0)
    ref = jp.phase_plain(tape, tc0.clone(), 1, side)
    start = ref.clone()
    start[lo:, :int(tape.lvl[-1])] = float("nan")
    got = _walk(tape, start, lo, _b4_item, _b4_synth, side)
    assert torch.equal(got, ref)
