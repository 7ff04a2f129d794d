"""Kernel B3's literal aliases (``rows._aliases``), its shared-memory
layout (``jet_rolled.block_layout``) and its packed tables, on the CPU.

The tables are held to the plain twin by an interpreter written here, one
lane and one item at a time as the kernel walks them (``_interpret``), so
that a wrong table shows on the CPU; the kernel itself is held to the twin
in tests/test_torch_gpu.py and ``chip_smoke.py``.  Where a test asks for
equal bits, the twin's order-k recurrences are swapped for
:func:`_eval_k_in_kernel_order`, which adds the terms one at a time in the
kernel's order: the twin's own reductions may group them otherwise."""

import math
import types

import numpy as np
import pytest
import torch

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.models import nbody
from heyoka_tpu_torch.taylor import jet_kernels as jk
from heyoka_tpu_torch.taylor import jet_rolled as jr
from heyoka_tpu_torch.taylor import rows
from heyoka_tpu_torch.taylor.compact import build_plan
from heyoka_tpu_torch.tools import GCONST, MASSES

from heyoka_tpu_torch.tools import mascon_body
from test_torch_rolled import CASES, _inputs, _mascon_kw, _t


def _chain3(m):
    # v = 3 (5 y + 1) is an alias of y with two literals; 2 (v + 1) would
    # take a third and keeps its history; -x is an alias with one
    x, y = m.make_vars("x", "y")
    v = 3.0 * (5.0 * y + 1.0)
    return [(x, v * x + (2.0 * (v + 1.0)) * y), (y, -x)]


SYSTEMS = {**{k: (lambda f: lambda: f(ht))(f) for k, f in CASES.items()},
           "chain3": lambda: _chain3(ht),
           "outer_ss": lambda: nbody(6, masses=MASSES, Gconst=GCONST)}
for _n in (12, 32, 512):
    SYSTEMS[f"mascon{_n}b"] = (lambda n: lambda: ht.models.mascon(
        **mascon_body(n)[0]))(_n)


def _plan(name, order):
    return build_plan(ht.taylor_decompose_sys(SYSTEMS[name]()), order)


def _tape(name, order):
    return jr.RolledTape(ht.plan_to_arrays(_plan(name, order)), "cpu")


def _args(name, B, seed=0):
    if name == "chain3":
        rng = np.random.default_rng(seed)
        st, pars, t = rng.uniform(-1, 1, (B, 2)), np.zeros((B, 0)), \
            np.zeros(B)
    else:
        st, pars, t = _inputs(name, B, seed)
    return _t(st.T), _t(pars.T), _t(t)


def _no_aliases(name, order):
    return jr.RolledTape(ht.plan_to_arrays(_plan(name, order)), "cpu",
                         _with_aliases=False)


def _eval_k_in_kernel_order(name, alpha, k, hist, nargs):
    """``jet_kernels._eval_k`` with every sum run in j ascending from 0.0,
    one add at a time, as csrc/taylor_jet_rolled.cu adds them: its bits do
    not depend on how many columns a group has or which are aliases."""
    if name == "sum":
        v = hist(0, k, k + 1)[0]
        for q in range(1, nargs):
            v = v + hist(q, k, k + 1)[0]
        return v
    if name == "mul":
        A, Bv = hist(0, 0, k + 1), hist(1, 0, k + 1)
        v = torch.zeros_like(A[0])
        for j in range(k + 1):
            v = v + A[j] * Bv[k - j]
        return v
    if name == "div":
        Q, Bv = hist(-1, 0, k), hist(1, 0, k + 1)
        s = torch.zeros_like(Bv[0])
        for j in range(k):
            s = s + Q[j] * Bv[k - j]
        return (hist(0, k, k + 1)[0] - s) / Bv[0]
    if name == "sqrt":
        Q = hist(-1, 0, k)
        s = torch.zeros_like(Q[0])
        for j in range(1, k):
            s = s + Q[j] * Q[k - j]
        return (hist(0, k, k + 1)[0] - s) / (2.0 * Q[0])
    Q, Av = hist(-1, 0, k), hist(0, 0, k + 1)
    s1, s2 = torch.zeros_like(Av[0]), torch.zeros_like(Av[0])
    for j in range(k):
        s1 = s1 + (Q[j] * Av[k - j]) * float(k - j)
        s2 = s2 + (float(j) * Q[j]) * Av[k - j]
    al = torch.as_tensor(alpha, device=Q.device)[:, None]
    return (s1 * al - s2) / (k * Av[0])


def _per_order_rel(a, b):
    # (n, K+1, B) blocks: max |a - b| per order, over the order's max |b|
    scale = b.abs().amax(dim=(0, 2))
    return (a - b).abs().amax(dim=(0, 2)) / torch.where(
        scale > 0, scale, torch.ones_like(scale))


# -- the counts -------------------------------------------------------------

# (tape, aliases, history rows, H rows before the aliases): mascon-N has 6N
# aliases (the 3N sums x_i - p_j, each (-1 x_i) + p_j, and the 3N m_j dx)
# and 2N + 9 history rows (6 state rows, N squared distances, N powers, 3
# right-hand sides); fixed_centres-N the same; the outer Solar System 90
# (the two mass products G m dx of each of 15 pairs, 3 coordinates)
@pytest.mark.parametrize("name,K,n_alias,n_hist,n_h", [
    ("mascon512b", 19, 3072, 1033, 4105),
    ("mascon12", 15, 72, 33, 105),
    ("fixed_centres10", 15, 60, 29, 89),
    ("outer_ss", 19, 90, 129, 219),
    ("chain3", 7, 4, 4, 8),
])
def test_alias_counts(name, K, n_alias, n_hist, n_h):
    tape = _tape(name, K)
    WH, WC, WV, NA, NS = tape.sizes
    assert (NA, WH, WH + NA) == (n_alias, n_hist, n_h)
    assert NS == np.unique(tape.alias_scales[tape.alias_scales >= 0]).size
    assert int((tape.classv == jr.A).sum()) == NA
    assert jr.lane_bytes(WH, NA, WC, K) == 8 * ((K + 1) * WH + NA + WC)


def test_mascon512_fits_a_block():
    # 1,033 x 20 x 8 + 3,072 x 8 + 3,079 x 8 = 214,488 B, under 232,448
    # with S (the literal -1 and the 512 masses), the zero and the staging
    # row; but an SM would hold one such block alone, so B3 takes the
    # global layout, 256 threads a block (1,536 items in its widest pass),
    # two blocks an SM
    tape = _tape("mascon512b", 19)
    assert tape.sizes == (1033, 3079, 2053, 3072, 513)
    assert tape.widest == 1536 and jr.block_threads(tape) == 256
    assert jr.block_layout(tape) == ("global", 214_488)
    smem = 214_488 + 8 * (513 + 1 + 256)
    assert jr.smem_bytes(tape, "smem", 256) == smem <= jr.SMEM_MAX
    assert jk.blocks_per_sm(smem, 256) == 1
    rep = jr.layout_report(tape)
    assert rep == dict(layout="global", lanes_per_block=1, threads=256,
                       smem_bytes=8 * (513 + 1 + 256), lane_bytes=214_488,
                       aliases=3072, tables="global")


# the widest pass of mascon-N at orders k >= 1 is one of its two product
# levels, 3N items (the squares, or the mass terms times r^-3); mascon-32's
# is as wide as its three wide sums' warps too (96), mascon-12's sums of 14
# operands are a thread's
@pytest.mark.parametrize("name,widest,threads,layout", [
    ("mascon12", 36, 64, "smem"),
    ("mascon32b", 96, 64, "smem"),
    ("outer_ss", 90, 64, "smem"),
    ("handbuilt_mixed", 7, 64, "smem"),
])
def test_block_shape_of_tapes(name, widest, threads, layout):
    tape = _tape(name, 19)
    assert (tape.widest, jr.block_threads(tape)) == (widest, threads)
    assert jr.block_layout(tape)[0] == layout
    rep = jr.layout_report(tape)
    assert rep["threads"] == threads
    assert jk.blocks_per_sm(rep["smem_bytes"], threads) >= 2


@pytest.mark.parametrize("widest,threads", [
    (0, 64), (191, 64), (383, 64), (384, 128), (767, 128), (768, 256),
    (10**6, 256)])
def test_block_threads_at_the_edges(widest, threads):
    # the largest block with three items a thread in the widest pass
    fake = types.SimpleNamespace(widest=widest)
    assert jr.block_threads(fake) == threads


@pytest.mark.parametrize("WH,NA,WC,K,layout", [
    (1000, 40, 8, 10, "smem"),     # 8 (11 000 + 40 + 8) = 88,384
    (10000, 48, 8, 22, "global"),  # 1,840,448
    (10000, 56, 0, 22, "global"),
    (1016, 3000, 3032, 19, "global"),  # 210,816: one block an SM
])
def test_block_layout_sizes(WH, NA, WC, K, layout):
    fake = types.SimpleNamespace(sizes=(WH, WC, 0, NA, 0), order=K,
                                 widest=100)
    per = 8 * ((K + 1) * WH + NA + WC)
    assert jr.block_layout(fake) == (layout, per)


@pytest.mark.parametrize("extra,layout", [(0, "smem"), (1, "global")])
def test_block_layout_at_the_edge(extra, layout):
    # two blocks an SM: 2 (smem + 1,024 reserved) <= 233,472, so a block
    # takes at most 115,712 B = 14,464 doubles: 600 history rows at K = 19
    # (12,000), 1,000 aliases, 1,143 C rows, 64 literals in S, the zero and
    # the staging row of a 256-thread block make it exactly; one more row
    # is over
    fake = types.SimpleNamespace(sizes=(600, 1143 + extra, 0, 1000, 64),
                                 order=19, widest=768)
    per = 8 * (12_000 + 1000 + 1143 + extra)
    assert jr.block_layout(fake) == (layout, per)
    rep = jr.layout_report(fake)
    assert rep["threads"] == 256
    assert rep["smem_bytes"] == (115_712 if layout == "smem"
                                 else 8 * (64 + 1 + 256))
    assert jk.blocks_per_sm(jr.smem_bytes(fake, "smem", 256), 256) \
        == 2 - extra


# -- the twin with and without the aliases -------------------------------------

@pytest.mark.parametrize("name", [*CASES, "chain3"])
def test_aliases_keep_the_twin_bit_for_bit(monkeypatch, name):
    # reading through the aliases gives the same coefficients and norms as
    # computing the aliased columns (torch.equal: equal values, the sign of
    # a zero aside), the terms summed in the kernel's order
    K = 12
    plain = _no_aliases(name, K)
    tape = _tape(name, K)
    assert plain.sizes[3] == plain.sizes[4] == 0 < tape.sizes[3]
    assert plain.sizes[0] == tape.sizes[0] + tape.sizes[3]
    args = _args(name, 5, seed=4)
    monkeypatch.setattr(jr, "_eval_k", _eval_k_in_kernel_order)
    a, b = jr.jet_rolled_plain(tape, *args), jr.jet_rolled_plain(plain, *args)
    assert bool(torch.isfinite(a[0]).all())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("name", [*CASES, "chain3"])
def test_aliases_keep_the_twin_within_1e15(name):
    # the twin as it runs, whose reductions may group a convolution's terms
    # by the size of the group: with and without the aliases within 1e-15
    # per order, norms too
    K = 12
    args = _args(name, 5, seed=4)
    a = jr.jet_rolled_plain(_tape(name, K), *args)
    b = jr.jet_rolled_plain(_no_aliases(name, K), *args)
    assert bool(torch.isfinite(a[0]).all())
    assert float(_per_order_rel(a[0], b[0]).max()) <= 1e-15
    assert float(((a[1] - b[1]).abs() / b[1].abs()).max()) <= 1e-15


def test_twin_shows_an_unsound_alias(monkeypatch):
    # a squared distance (a sum of three non-literal operands) marked as an
    # alias of x: the twin reads x's orders for it and must go wrong
    K = 9
    args = _args("mascon12", 4)
    good = jr.jet_rolled_plain(_tape("mascon12", K), *args)[0]
    real = rows._aliases

    def bad(plan, classv):
        out = real(plan, classv)
        g = next(g for lv in plan.levels for g in lv
                 if g.name == "sum" and g.in_cols.shape[1] == 3)
        out[int(g.out_cols[0])] = (0, ())
        return out

    monkeypatch.setattr(jr, "_aliases", bad)
    bad_tape = _tape("mascon12", K)
    assert bad_tape.sizes[3] == 73
    got = jr.jet_rolled_plain(bad_tape, *args)[0]
    assert torch.equal(got[:, :2], good[:, :2])  # orders 0 and 1 hold
    assert not torch.allclose(got, good, rtol=1e-6, atol=0)


def test_chain_applies_its_literals_one_after_the_other():
    # v = 3 (5 y + 1): v's order k is 3 * (5 * y_k), which is not 15 * y_k
    # for every y_k; 2 (v + 1) would take a third literal and is a root
    plan = _plan("chain3", 7)
    classv = rows._row_classes(plan)[0]
    al = rows._aliases(plan, classv)
    consts = dict(plan.const_cols)
    by_vals = {c: (r, tuple(consts[s] for s in sc))
               for c, (r, sc) in al.items()}
    assert sorted(by_vals.values()) == [(0, (-1.0,)), (1, (5.0,)),
                                        (1, (5.0, 3.0)), (1, (5.0, 3.0))]
    third = next(g.out_cols[0] for lv in plan.levels for g in lv
                 if g.name == "mul" and set(g.in_cols[0].tolist())
                 & {c for c, v in consts.items() if v == 2.0})
    assert classv[third] == 0 and int(third) not in al
    y = np.array([0.1 + 1e-9 * i for i in range(1000)])
    assert (3.0 * (5.0 * y) != 15.0 * y).any()  # why the order matters
    tape = _tape("chain3", 7)
    args = _args("chain3", 3, seed=1)
    tc = jr.jet_rolled_plain(tape, *args)[0]
    assert bool(torch.isfinite(tc).all())


# -- the packed tables -----------------------------------------------------------

def test_alias_table_of_mascon12():
    # 72 aliases: 36 sums dx = (-x_i) + p_j with the literal -1, 36 products
    # m_j dx with -1 and then m_j; every root a position row (0, 1, 2)
    tape = _tape("mascon12", 15)
    it = tape.ritab.numpy()
    hdr = dict(zip(jr._RHDR, it[:len(jr._RHDR)].tolist()))
    assert hdr["alias"] % 4 == 0  # 16-byte records
    rec = it[hdr["alias"]:hdr["alias"] + 4 * 72].reshape(72, 4)
    np.testing.assert_array_equal(rec[:, 0], tape.alias_root)
    # the literals as S indices; S lists each V row once
    srows = it[hdr["srows"]:hdr["srows"] + hdr["NS"]]
    assert hdr["NS"] == 13 and (np.diff(srows) > 0).all()
    sc = np.where(rec[:, 1:3] >= 0, srows[rec[:, 1:3]], -1)
    np.testing.assert_array_equal(sc, tape.alias_scales)
    assert (rec[:, 3] == 0).all() and set(rec[:, 0]) == {0, 1, 2}
    vrow = {int(tape.rowmap[c]): v for c, v in
            zip(tape.arrays["const_cols"], tape.arrays["const_vals"])}
    rec = np.concatenate([rec[:, :1], sc], 1)
    s0 = [vrow[s] for s in rec[:, 1]]
    assert s0 == [-1.0] * 72
    two = rec[:, 2] >= 0
    assert two.sum() == 36
    masses = _mascon_kw(12, 7)["masses"]
    assert sorted(vrow[s] for s in rec[two, 2]) == sorted(
        [m for m in masses for _ in range(3)])


def _segments(tape, key):
    it = tape.ritab.numpy()
    hdr = dict(zip(jr._RHDR, it[:len(jr._RHDR)].tolist()))
    lvl = it[hdr[key]:hdr[key] + hdr["n_levels"] + 1]
    n_seg = it[hdr["lvlk"] + hdr["n_levels"]]  # the last segment's end
    seg = it[hdr["seg"]:hdr["seg"] + jr.SEG_INTS * n_seg].reshape(
        -1, jr.SEG_INTS)
    return hdr, it, [seg[lvl[i]:lvl[i + 1]] for i in range(len(lvl) - 1)]


@pytest.mark.parametrize("name", ["mascon32b", "handbuilt_mixed"])
def test_item_lists(name):
    # order 0 lists every op column, orders k >= 1 every one that is not an
    # alias; a fixed arity per instance-regular segment, wide sums by warp
    tape = _tape(name, 9)
    n_eq = tape.n_eq
    n_ops = tape.arrays["arg_ptr"].size - 1
    ops = n_eq + np.arange(n_ops)
    loc = (tape.classv.astype(np.int64) << jr.CLS_SHIFT) | tape.rowmap
    for key, want in (("lvl0", ops), ("lvlk", ops[tape.classv[ops] != jr.A])):
        hdr, it, levels = _segments(tape, key)
        rec = it[hdr["rec"]:]
        off = it[hdr["off"]:]
        outs, wide = [], []
        for segs in levels:
            for op, n, first, ar, aux, per in segs:
                # resolved operands only where an order-k item reads an
                # alias
                assert per == 1 or (key == "lvlk" and per == jr.RESOLVED)
                for i in range(n):
                    if ar > 0:
                        r = rec[first + i * (1 + ar * per):][:1 + ar * per]
                    else:
                        b, e = off[aux + i], off[aux + i + 1]
                        r = rec[first + b:first + e]
                    outs.append(r[0])
                    c = ops[loc[ops] == r[0]][0]
                    o = c - n_eq
                    a = tape.arrays["args"][tape.arrays["arg_ptr"][o]:
                                            tape.arrays["arg_ptr"][o + 1]]
                    np.testing.assert_array_equal(r[1::per], loc[a])
                    for w, root, sp in r[1:].reshape(-1, 3) if per > 1 \
                            else ():
                        if w >> jr.CLS_SHIFT == jr.A:
                            i_a = w & ((1 << jr.CLS_SHIFT) - 1)
                            assert root == tape.alias_root[i_a]
                            assert [sp & 0xFFFF, sp >> 16] == list(
                                tape.alias_s[i_a] + 1)
                        else:
                            assert root == sp == 0
                    assert ht.convert.OPCODES[op] == next(
                        g[0] for g in tape.groups
                        if g[1] <= c < g[1] + g[2])
                if ar == jr.SEG_WIDE:
                    wide.append((ht.convert.OPCODES[op], n))
        np.testing.assert_array_equal(np.sort(outs), np.sort(loc[want]))
        # mascon-32's three sums of 34 operands (the 32 mascons' terms and
        # the frame's two) go to a warp each
        assert wide == ([("sum", 3)] if name == "mascon32b" else [])


def _pow0(b, a):
    # csrc pow0, one value, as the twin computes it
    return float(jk._pow0_plain(torch.tensor([b], dtype=torch.float64), a)[0])


def _interpret(tape, state, pars, t):
    """Kernel B3's walk over its packed tables, one lane and one item at a
    time, in Python floats: the same reads, the same expressions and the
    same order of the terms as csrc/taylor_jet_rolled.cu."""
    it = tape.ritab.numpy().astype(np.int64)
    dt = tape.rdtab.numpy()
    h = dict(zip(jr._RHDR, it[:len(jr._RHDR)].tolist()))
    K, n_eq, WH, WC, WV, NA = (h[k] for k in ("K", "n_eq", "WH", "WC",
                                               "WV", "NA"))
    mask = (1 << jr.CLS_SHIFT) - 1

    def sub(key, n):
        return it[h[key]:h[key] + n]

    alias = sub("alias", 4 * NA).reshape(NA, 4)
    srows = sub("srows", h["NS"])
    n_seg = it[h["lvlk"] + h["n_levels"]]
    seg = sub("seg", jr.SEG_INTS * n_seg).reshape(-1, jr.SEG_INTS)
    rec, off = it[h["rec"]:], it[h["off"]:]
    cvals, alpha = dt[h["d_cvals"]:], dt[h["d_alpha"]:]
    state, pars, t = (x.numpy() for x in (state, pars, t))
    B = state.shape[1]
    outc = sub("outc", h["n_out"])
    out = np.empty((n_eq + outc.size, K + 1, B))
    norms = np.empty((3, B))
    for lane in range(B):
        H = np.full((K + 1, WH), np.nan)
        A = np.full(NA, np.nan)
        C = np.full(WC, np.nan)
        V = np.full(WV, np.nan)
        H[0, :n_eq] = state[:, lane]
        V[sub("crows", h["n_const"])] = cvals[:h["n_const"]]
        for r, j in zip(sub("prows", h["n_pcol"]), sub("pidx", h["n_pcol"])):
            V[r] = pars[j, lane]
        if h["time_row"] >= 0:
            H[:, h["time_row"]] = 0.0
            H[0, h["time_row"]], H[1, h["time_row"]] = t[lane], 1.0
        S = V[srows]

        def val0(loc):
            row = loc & mask
            return (H[0], C, V, A)[loc >> jr.CLS_SHIFT][row]

        def refk(loc, res=None):
            # res: the (root, packed S indices) of a resolved operand
            cls, row = loc >> jr.CLS_SHIFT, loc & mask
            if cls == jr.C:
                return lambda j: C[row]
            if cls == jr.V:
                return lambda j: 0.0
            if cls == jr.H:
                r, sidx = row, []
            elif res is None:
                r, sidx = alias[row, 0], alias[row, 1:3]
            else:
                r, sidx = res[0], [(res[1] & 0xFFFF) - 1, (res[1] >> 16) - 1]
            scales = [S[s] for s in sidx if s >= 0]

            def get(j):
                x = H[j, r]
                for s in scales:
                    x = s * x
                return x
            return get

        def value(loc, j):
            return val0(loc) if j == 0 else refk(loc)(j)

        def store(loc, k, v):
            cls, row = loc >> jr.CLS_SHIFT, loc & mask
            if cls == jr.H:
                H[k, row] = v
            elif cls == jr.C:
                C[row] = v
            else:
                assert cls == jr.A and k == 0
                A[row] = v

        def item(op, r, k, al, per):
            name = ht.convert.OPCODES[op]
            a = r[1::per]
            res = [None] * len(a) if per == 1 else \
                r[1:].reshape(-1, 3)[:, 1:].tolist()

            def refq(q):
                return refk(a[q], res[q])
            if k == 0:
                if name == "sum":
                    v = val0(a[0])
                    for q in a[1:]:
                        v += val0(q)
                    return v
                if name == "mul":
                    return val0(a[0]) * val0(a[1])
                if name == "div":
                    return val0(a[0]) / val0(a[1])
                if name == "sqrt":
                    return math.sqrt(val0(a[0]))
                return _pow0(val0(a[0]), al)
            if name == "sum":
                v = refq(0)(k)
                for q in range(1, len(a)):
                    v += refq(q)(k)
                return v
            if name == "mul":
                Af, Bf = refq(0), refq(1)
                v = 0.0
                v += val0(a[0]) * Bf(k)
                for j in range(1, k):
                    v += Af(j) * Bf(k - j)
                v += Af(k) * val0(a[1])
                return v
            Q = refk(r[0])
            if name == "div":
                Bf = refq(1)
                s = 0.0
                for j in range(k):
                    s += Q(j) * Bf(k - j)
                return (refq(0)(k) - s) / val0(a[1])
            if name == "sqrt":
                s = 0.0
                for j in range(1, k):
                    s += Q(j) * Q(k - j)
                return (refq(0)(k) - s) / (2.0 * Q(0))
            Af = refq(0)
            s1 = s2 = 0.0
            for j in range(k):
                q, bb = Q(j), Af(k - j)
                s1 += (q * bb) * float(k - j)
                s2 += (float(j) * q) * bb
            return (s1 * al - s2) / (float(k) * val0(a[0]))

        def level(segs, k):
            for op, n, first, ar, aux, per in segs:
                for i in range(n):
                    if ar > 0:
                        r = rec[first + i * (1 + ar * per):][:1 + ar * per]
                    else:
                        b, e = off[aux + i], off[aux + i + 1]
                        r = rec[first + b:first + e]
                    al = alpha[aux + i] if ht.convert.OPCODES[op] == "pow" \
                        else 0.0
                    store(r[0], k, item(op, r, k, al, per))

        lv0 = sub("lvl0", h["n_levels"] + 1)
        lvk = sub("lvlk", h["n_levels"] + 1)
        for lv in range(h["n_levels"]):
            level(seg[lv0[lv]:lv0[lv + 1]], 0)
        for k in range(1, K + 1):
            for i, loc in enumerate(sub("rhs", n_eq)):
                H[k, i] = value(loc, k - 1) / float(k)
            for lv in range(h["n_levels"]):
                level(seg[lvk[lv]:lvk[lv + 1]], k)
        nrm = sub("norm", h["n_norm"])
        for o, j in enumerate((K - 1, K, 0)):
            norms[o, lane] = max(abs(value(loc, j)) for loc in nrm)
        out[:n_eq, :, lane] = H[:, :n_eq].T
        # the sv-func rows (event equations), each through its location
        # word as the norms read it: an alias through its root
        for j, loc in enumerate(outc):
            out[n_eq + j, :, lane] = [value(loc, k) for k in range(K + 1)]
    return torch.as_tensor(out), torch.as_tensor(norms)


def test_event_rows_walk_to_the_twin(monkeypatch):
    # with event equations (an alias-form x - 1.5, an alias of an alias
    # 3 * (x - 1.5), an impact sum and a state column) the kernel's walk
    # gives the twin's rows bit for bit, the aliases read through their
    # root; the alias-form events keep order 0 only (8 bytes a lane each)
    sys_ = SYSTEMS["mascon12"]()
    x, y, z = (lhs for lhs, _ in sys_[:3])
    evs = [x - 1.5, 3.0 * (x - 1.5), x * x + y * y + z * z - 1.0, y]
    arrays = ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(sys_, extra_outputs=evs), 8))
    tape = jr.RolledTape(arrays, "cpu")
    oc = arrays["out_cols"].astype(np.int64)
    assert (tape.classv[oc[:2]] == jr.A).all() and oc[3] == 1
    bare = _tape("mascon12", 8)
    assert tape.sizes[0] > bare.sizes[0]  # the impact's columns
    args = _args("mascon12", 2, seed=8)
    tc_i, n_i = _interpret(tape, *args)
    monkeypatch.setattr(jr, "_eval_k", _eval_k_in_kernel_order)
    tc_p, n_p = jr.jet_rolled_plain(tape, *args)
    assert tc_p.shape[0] == tape.n_eq + 4
    assert torch.equal(tc_i, tc_p) and torch.equal(n_i, n_p)
    np.testing.assert_array_equal(tc_p[tape.n_eq, 1:], tc_p[0, 1:])
    np.testing.assert_array_equal(tc_p[tape.n_eq + 3], tc_p[1])


@pytest.mark.parametrize("name", ["mascon12", "handbuilt_mixed", "nbody3",
                                  "chain3"])
def test_tables_walk_to_the_twin(monkeypatch, name):
    # the kernel's walk over its tables gives the values of the twin that
    # sums in the kernel's order exactly, and the twin's within 1e-15
    tape = _tape(name, 8)
    args = _args(name, 2, seed=6)
    tc_i, n_i = _interpret(tape, *args)
    tc_p, n_p = jr.jet_rolled_plain(tape, *args)
    assert float(_per_order_rel(tc_i, tc_p).max()) <= 1e-15
    monkeypatch.setattr(jr, "_eval_k", _eval_k_in_kernel_order)
    tc_p, n_p = jr.jet_rolled_plain(tape, *args)
    assert torch.equal(tc_i, tc_p) and torch.equal(n_i, n_p)


def test_launch_config_on_the_cpu():
    # threads of 64, 128 or 256; the other layout on request, one block
    # per lane on the CPU (the card gives GLOBAL_SM_THREADS an SM)
    tape = _tape("mascon12", 15)
    per = jr.block_layout(tape)[1]
    NS = tape.sizes[4]
    assert jr._launch_cfg(tape, 7, torch.device("cpu"))[:4] == (
        64, per + 8 * (NS + 1 + 64), per // 8, 7)
    nt, smem, dbl, blocks, scratch = jr._launch_cfg(
        tape, 7, torch.device("cpu"), 256, "global")
    assert (nt, smem, dbl, blocks) == (256, 8 * (NS + 1 + 256), per // 8, 7)
    assert scratch.numel() == 7 * per // 8
    with pytest.raises(ValueError):
        jr._launch_cfg(tape, 7, torch.device("cpu"), 512)
    with pytest.raises(ValueError):
        jr._launch_cfg(_tape("mascon32b", 19), 7, torch.device("cpu"),
                       None, "nowhere")
    with pytest.raises(ValueError):  # mascon-1024's lane: over a block
        fake = types.SimpleNamespace(sizes=(2057, 6151, 0, 6144, 1025),
                                     order=19, widest=3072)
        jr._launch_cfg(fake, 7, torch.device("cpu"), None, "smem")


def test_trace_of_the_passes():
    # a traced launch's readings: start, seeds, each level of order 0, then
    # per order k >= 1 the state rows and each level with items (mascon-12:
    # 7 levels, level 1 all aliases at k >= 1), and the end
    from heyoka_tpu_torch.tools import rolled_scan
    tape = _tape("mascon12", 9)
    n_lv = len(_plan("mascon12", 9).levels)
    assert n_lv == 7
    assert jr.trace_len(tape) == 3 + 7 + 9 * (1 + 6)
    clock = torch.as_tensor(np.cumsum(np.arange(jr.trace_len(tape)) % 5))
    got = rolled_scan.passes(tape, clock)
    assert got["total"] == int(clock[-1] - clock[0])
    assert sum(v for k, v in got.items() if k != "total") == got["total"]
    assert "level1" not in got and "level0" in got and "level6" in got
