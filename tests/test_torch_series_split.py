"""Kernel S1's two classes of terms on the CPU (``taylor/series_jet.py``):
the split of each series into the linear class L (the closed form, kernel
S1-L) and the general class G (the recurrence, kernel S1-G), the closed
form against the recurrence on the same terms, the work list of a step,
the packed fragments kernel S1-L reads, the launches of ``order0``, and
the split twin against the JAX package's ``_series_jet``.  The kernels
themselves are held against the twin in tests/test_torch_gpu.py and in
chip_smoke.py phase 24.

The JAX reference runs in full f64 (``_FAST = False`` and no cached
head/tail split), as tests/test_torch_series.py sets it."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import heyoka_tpu as hy
from heyoka_tpu.expr import series as JS

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.expr import series as PS
from heyoka_tpu_torch.taylor import jet_phase as jp
from heyoka_tpu_torch.taylor import series_jet as sj
from heyoka_tpu_torch.taylor.compact import build_plan
from heyoka_tpu_torch.tools.cases import (
    elp_sys, p9_sys, random_series, series_times,
)

from chip_smoke import seeded_buffer

F64 = torch.float64
#: the complete ELP2000's 9 ops at K = 19: class-L and class-G terms
ELP_LIN = [19, 1897, 7009, 13, 1036, 5717, 28, 4630, 14879]
ELP_GEN = [0, 0, 701, 0, 0, 917, 0, 0, 1017]


def _drop_splits():
    for d in JS._STORE.values():
        d.pop("head", None)
        d.pop("tail", None)


@pytest.fixture(scope="module", autouse=True)
def full_f64():
    old = JS._FAST
    JS._FAST = False
    _drop_splits()
    yield
    JS._FAST = old
    _drop_splits()


def _names(sys_):
    return [op.op for op in ht.taylor_decompose_sys(sys_).ops
            if PS.is_series(op.op)]


def _mixed(seed, n=400, q=2, d=4):
    """Tables with both classes: a random series whose odd rows are made
    linear with a constant amplitude."""
    amp, ph = random_series(np.random.default_rng(seed), n, q, d)
    amp[1::2, 1:] = 0.0
    ph[1::2, 2:] = 0.0
    return amp, ph


# -- the split ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_split_of_mixed_tables(seed):
    # the class rule term by term, in table order; the op's name, key and
    # tables stay as they are
    amp, ph = _mixed(seed)
    name = PS.add(amp, ph)
    before = [x.tobytes() for x in PS.tables(name)]
    tab = sj.tables_on(name, "cpu")
    sp = sj.split_of(tab, 19)
    want = ((amp[:, 1:] == 0).all(1) & (ph[:, 2:] == 0).all(1))
    assert np.array_equal(sp.lin, np.flatnonzero(want))
    assert np.array_equal(sp.gen, np.flatnonzero(~want))
    assert sp.lin.size == 200 and sp.gen.size == 200
    assert [x.tobytes() for x in PS.tables(name)] == before
    assert PS.add(amp, ph) == name and sj.tables_on(name, "cpu") is tab
    np.testing.assert_array_equal(sp.gen_tab.amp.numpy(), amp[sp.gen])
    np.testing.assert_array_equal(sp.gen_tab.ph.numpy(), ph[sp.gen])
    np.testing.assert_array_equal(sp.ph0.numpy(), ph[sp.lin, 0])
    np.testing.assert_array_equal(sp.ph1.numpy(), ph[sp.lin, 1])
    # the weights: a w^m with the sign of sin(x + m pi/2)
    W = sp.W.numpy()
    a, w = amp[sp.lin, 0], ph[sp.lin, 1]
    for m in range(20):
        sign = -1.0 if m % 4 >= 2 else 1.0
        np.testing.assert_allclose(W[m], sign * a * w ** m, rtol=1e-14)
    assert sj.split_of(tab, 19) is sp


def test_split_of_the_complete_elp2000():
    # 35,228 of the 37,863 terms are linear at K = 19, per op as counted;
    # the ops keep their names and the JAX package's tables
    names = _names(elp_sys(ht, 0.0))
    elp_sys(hy, 0.0)  # the JAX model's tables in its store
    lin, gen = [], []
    for nm in names:
        sp = sj.split_of(sj.tables_on(nm, "cpu"), 19)
        lin.append(sp.lin.size)
        gen.append(sp.gen.size)
        a, p = PS.tables(nm)
        assert a.tobytes() == JS._STORE[PS.key_of(nm)]["amp"].tobytes()
        assert p.tobytes() == JS._STORE[PS.key_of(nm)]["ph"].tobytes()
    assert lin == ELP_LIN and gen == ELP_GEN
    assert sum(lin) == 35_228 and sum(gen) == 2_635
    # planet 9's ops are all linear
    for nm in _names(p9_sys(ht, 1e-9)):
        assert sj.split_of(sj.tables_on(nm, "cpu"), 19).gen.size == 0


def test_range_guard_sends_huge_rates_to_class_g():
    # a weight a w^m out of f64's normal range at some m <= K goes to class
    # G: a huge rate overflows, a tiny one or a subnormal amplitude
    # underflows; w = 0 stays linear (0^0 = 1), as does a = 0
    amp = np.array([[1.0], [1.0], [1.0], [1e-310], [0.0], [1.0], [2.0]])
    ph = np.array([[0.1, 1e20], [0.2, 1e-20], [0.3, 0.0], [0.4, 1.0],
                   [0.5, 1e300], [0.6, 3.0], [0.7, 6e4]])
    assert sj.lin_mask(amp, ph, 19).tolist() == [
        False, False, True, False, True, True, True]
    assert sj.lin_mask(amp, ph, 0).tolist() == [
        True, True, True, False, True, True, True]
    # 6e4^m: 2^(15.9 m) leaves the range above m = 64
    assert sj.lin_mask(amp, ph, sj.LIN_MAX_ORDER)[-1]
    assert not sj.lin_mask(amp, ph, sj.LIN_MAX_ORDER + 1).any()
    W = sj.lin_weights(np.array([2.5]), np.array([0.0]), 5)[:, 0]
    assert W.tolist() == [2.5, 0.0, -0.0, -0.0, 0.0, 0.0]
    # the twin takes the huge-rate term by the recurrence
    name = PS.add(amp, ph)
    tab = sj.tables_on(name, "cpu")
    sp = sj.split_of(tab, 19)
    assert sp.gen.tolist() == [0, 1, 3]
    u0 = torch.tensor([0.0, 1e-30], dtype=F64)
    u1 = torch.tensor([1e-25, 1e-22], dtype=F64)
    got = sj.series_jet_plain(tab, u0, u1, 19)
    assert bool(torch.isfinite(got).all())


# -- the closed form against the recurrence -----------------------------------

@pytest.mark.parametrize("K", [0, 1, 5, 19, 24])
@pytest.mark.parametrize("u1", [1.0, 1.0 / 36525.0])
def test_closed_form_matches_the_recurrence(K, u1):
    # the same linear terms (rates up to 6e4, phases up to 3e4 rad at
    # |u0| <= 0.5) by both rules: each order within 1e-13 of its summed
    # term magnitudes, and the scales alike
    rng = np.random.default_rng(K)
    n = 700
    amp = rng.uniform(-2.0, 2.0, (n, 1))
    ph = np.zeros((n, 5))
    ph[:, 0] = rng.uniform(0.0, 6.3, n)
    ph[:, 1] = rng.uniform(-6e4, 6e4, n)
    ph[:5, 1] = 0.0  # a constant phase
    tab = sj.tables_on(PS.add(amp, ph), "cpu")
    sp = sj.split_of(tab, K)
    assert sp.lin.size == n
    B = 33
    u0 = torch.as_tensor(rng.uniform(-0.5, 0.5, B))
    u1t = torch.full((B,), u1, dtype=F64)
    got, gs = sj._closed_form(sp, u0, u1t, K, with_scale=True)
    want, ws = sj._recurrence(tab, u0, u1t, K, with_scale=True)
    assert bool(((got - want).abs() <= 1e-13 * ws).all())
    assert bool(((gs - ws).abs() <= 1e-13 * ws).all())
    assert bool((ws > 0).all())
    # the twin is the two classes' sum: here class L alone
    assert torch.equal(sj.series_jet_plain(tab, u0, u1t, K), got)


def test_twin_adds_the_two_classes():
    # mixed tables: the twin is the closed form plus the recurrence over
    # the class-G rows, within 1e-14 of the recurrence over every row
    amp, ph = _mixed(3, n=501)
    tab = sj.tables_on(PS.add(amp, ph), "cpu")
    u0 = torch.linspace(-0.5, 0.5, 17, dtype=F64)
    u1 = torch.full((17,), 0.9, dtype=F64)
    got, scale = sj.series_jet_plain(tab, u0, u1, 12, with_scale=True)
    want, wscale = sj._recurrence(tab, u0, u1, 12, with_scale=True)
    assert bool(((got - want).abs() <= 1e-14 * wscale).all())
    torch.testing.assert_close(scale, wscale, rtol=1e-14, atol=0)


# -- the work list ------------------------------------------------------------

@pytest.mark.parametrize("B", [16, 10_240])
@pytest.mark.parametrize("which", ["both", "lin", "gen"])
def test_work_list_takes_every_term_once_in_order(B, which):
    # the complete ELP2000's 9 series in one work list: each series' class-L
    # tiles and class-G rows in chunks, in term order, every one once; a
    # series' slots consecutive, its class-L chunks first
    tabs = [sj.tables_on(nm, "cpu") for nm in _names(elp_sys(ht, 0.0))]
    work = sj.SeriesWork(tabs, 19)
    wl = work.items(B, which)
    slots = []
    tile0 = off = 0
    for i, (sp, rw) in enumerate(zip(work.splits, work.rw)):
        lin = wl.lin[wl.lin[:, 0] == i]
        gen = wl.gen[wl.gen[:, 0] == i]
        nt = -(-sp.lin.size // sj.LIN_TERMS)
        if which != "gen":
            starts = np.concatenate([[tile0], tile0 + np.cumsum(lin[:, 2])])
            assert np.array_equal(lin[:, 1], starts[:-1])
            assert starts[-1] == tile0 + nt
        else:
            assert lin.size == 0
        if which != "lin":
            got = np.concatenate([np.arange(o, o + k * rw).reshape(k, rw)[:, 0]
                                  for o, k in gen[:, 1:3]]) if gen.size \
                else np.zeros(0, int)
            assert np.array_equal(got, off + rw * np.arange(sp.gen.size))
            assert np.all(gen[:, 3:6] == (1, 5, rw))
        else:
            assert gen.size == 0
        s = np.concatenate([lin[:, 3], gen[:, 6]])
        assert np.array_equal(s, np.arange(wl.sstart[i], wl.sstart[i + 1]))
        slots += s.tolist()
        tile0 += nt
        off += sp.gen.size * rw
    assert slots == list(range(wl.n_slots))


def test_pack_lin_holds_the_fragments():
    # kernel S1-L's tiles: ph0, ph1 and W's m16n8k16 A fragments, read
    # back through the layout the kernel assumes, give W and the phases
    amp, ph = random_series(np.random.default_rng(8), 37, 0, 1)
    tab = sj.tables_on(PS.add(amp, ph), "cpu")
    for K, mt in ((19, 1), (40, 2)):
        sp = sj.split_of(tab, K)
        tiles = sj.pack_lin(sp, mt)
        assert tiles.shape == (3, sj.lin_tile_doubles(mt))
        W = np.zeros((K + 1, 48))
        W[:, :37] = sp.W.numpy()
        np.testing.assert_array_equal(tiles[:, :16].reshape(-1)[:37],
                                      ph[:, 0])
        np.testing.assert_array_equal(tiles[:, 16:32].reshape(-1)[:37],
                                      ph[:, 1])
        for t in range(3):
            for par in range(2):
                for m_ in range(mt):
                    for lane in range(32):
                        for i in range(8):
                            j, e = divmod(i, 2)
                            x = tiles[t, 32 + (par * mt + m_) * 256
                                      + j * 64 + 2 * lane + e]
                            m = 2 * (16 * m_ + lane // 4 + 8 * (i % 2)) + par
                            k = 16 * t + lane % 4 + 4 * (i // 2)
                            assert x == (W[m, k] if m <= K else 0.0)


# -- order0's launches --------------------------------------------------------

@pytest.mark.parametrize("which", ["elp", "p9"])
def test_order0_makes_every_series_in_one_launch(which, monkeypatch):
    # the series of the ELP2000 and planet-9 tapes are made together,
    # once a step, before the first group that reads one; the buffer
    # equals one series at a time through the twin, and order 0 of each
    # series column is its row's
    sys_ = elp_sys(ht, 1e-4) if which == "elp" else p9_sys(ht, 1e-7)
    tape = jp.PhaseTape(ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(sys_), 9)), "cpu")
    assert list(tape.ser_launches.values()) == [tuple(range(tape.n_ser))]
    calls = []
    real = sj.series_jets

    def spy(work, U0, U1, out, rows):
        calls.append(tuple(rows))
        return real(work, U0, U1, out, rows)
    monkeypatch.setattr(jp, "series_jets", spy)
    B = 5
    tc = seeded_buffer(tape, np.zeros((B, len(sys_))), np.zeros((B, 0)),
                       series_times(B, 3), "cpu")
    calls.clear()  # seeded_buffer ran order0 too
    ser = jp.order0(tape, tc)
    assert calls == [tuple(range(tape.n_ser))]
    for r, (col, aff, tab) in enumerate(tape.series):
        want = sj.series_jet_plain(tab, tc[0, aff.in_col].contiguous(),
                                   aff.u1(tc), 9)
        assert torch.equal(ser[:, r], want)
        assert torch.equal(tc[0, col], ser[0, r])


def test_series_launches_wait_for_a_reader():
    # a group that reads a series column met before it makes the pending
    # series first: x' = S1(t) * S2(t + p0) + S3(t) has them all
    # before the product that reads them; y' = S4(t) alone at the end
    rng = np.random.default_rng(4)
    x, y = ht.make_vars("x", "y")
    s = [PS.trig_series(u, *random_series(rng, 9, 0, 1))
         for u in (ht.time, ht.time + ht.par[0], ht.time, 2.0 * ht.time)]
    sys_ = [(x, s[0] * s[1] + s[2]), (y, s[3] - 0.1 * y)]
    arrays = ht.plan_to_arrays(build_plan(ht.taylor_decompose_sys(sys_), 7))
    tape = jp.PhaseTape(arrays, "cpu")
    assert sorted(r for rows in tape.ser_launches.values() for r in rows) \
        == list(range(4))
    B = 3
    tc = seeded_buffer(tape, rng.uniform(-1, 1, (B, 2)),
                       rng.uniform(-1, 1, (B, 1)), rng.uniform(-1, 1, B),
                       "cpu")
    ser = jp.order0(tape, tc)
    jp.phase_plain(tape, tc, 1, ser)
    for r, (col, aff, tab) in enumerate(tape.series):
        assert torch.equal(tc[:, col], ser[:, r])
        assert torch.equal(ser[:, r], sj.series_jet_plain(
            tab, tc[0, aff.in_col].contiguous(), aff.u1(tc), 7))


# -- the twin against the JAX package's _series_jet ---------------------------

def _jax_jet(name, u0, u1, K):
    """Orders 1..K of the JAX package's ``_series_jet`` at lanes ``u0``,
    ``u1`` (numpy (B,)), unscaled: ``(K, B)``."""
    amp, ph = PS.tables(name)
    ent = JS._series_jet(jnp, amp, ph, u0, u1, K, None)
    lam = np.asarray(ent["lam_e"], np.float64)
    return np.stack([np.asarray(ent["f"][m - 1]) * 2.0 ** (m * lam)
                     for m in range(1, K + 1)])


@pytest.mark.parametrize("which", ["elp", "p9"])
def test_twin_matches_jax_series_jet(which):
    # every series of the complete ELP2000 tape and of planet 9's, orders
    # 1..19 at 6 lanes: the split twin within 2e-12 of each order's summed
    # term magnitudes of the JAX recurrence, and within 1e-14 of the
    # recurrence over every term.  XLA's CPU sin at ELP2000's phases sits
    # up to 6.7e-13 of that scale from numpy's at order 0
    # (tests/test_torch_series.py); over orders 1..19 the JAX jet sits
    # 1.2e-12 from the recurrence over every term and from the split twin
    # alike (measured on this case)
    K, B = 19, 6
    rng = np.random.default_rng(19)
    u0 = rng.uniform(-0.5, 0.5, B)
    u1 = np.full(B, 1.0 if which == "elp" else 0.1)
    names = _names(elp_sys(ht, 0.0) if which == "elp"
                   else p9_sys(ht, 1e-9))
    assert len(names) == (9 if which == "elp" else 15)
    for nm in names:
        tab = sj.tables_on(nm, "cpu")
        u0t, u1t = torch.as_tensor(u0), torch.as_tensor(u1)
        got, scale = sj.series_jet_plain(tab, u0t, u1t, K, with_scale=True)
        rec = sj._recurrence(tab, u0t, u1t, K)
        assert bool(((got - rec).abs() <= 1e-14 * scale).all()), nm
        want = _jax_jet(nm, u0, u1, K)
        err = np.abs(got[1:].numpy() - want) / scale[1:].numpy()
        assert err.max() <= 2e-12, (nm, err.max())
        assert math.isfinite(float(scale.max()))


# -- the variants of tools/series_scan.py -------------------------------------

def test_series_scan_variants_replace_their_lines():
    # each variant of kernel S1-L that tools/series_scan.py times differs
    # from the source by its own lines; an unknown tag and a source without
    # the lines raise
    from heyoka_tpu_torch import _build
    from heyoka_tpu_torch.tools import series_scan as ss
    src = (_build.CSRC / "series_jet.cu").read_text()
    got = {t: ss.variant_source(t, src) for t in ss.VARIANTS}
    assert got["kernel"] == src
    assert "sincos(x, &s, &c)" in got["library_sincos"]
    assert ss.MMA_EVEN not in got["no_products"]
    assert ss.MMA_ODD not in got["no_products"]
    assert ss.SINCOS not in got["no_sincos"]
    assert ss.SINCOS not in got["library_sincos"]
    assert len(set(got.values())) == len(ss.VARIANTS)
    with pytest.raises(ValueError, match="unknown variant"):
        ss.variant_source("fast", src)
    with pytest.raises(ValueError, match="has no line"):
        ss.variant_source("kernel", src.replace(ss.SINCOS, ""))
