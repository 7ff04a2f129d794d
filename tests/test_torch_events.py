"""The port's event step (``heyoka_tpu_torch/taylor/events_impl.py``)
against the JAX package's (``heyoka_tpu/taylor/events_impl.py``), on the
CPU in f64: the tree isolator, the Collins-Akritas isolator and the root
refinement on seeded polynomials, and ``ev_step_b`` over the jets of the
three routes of ``tools/cases.py`` (B2's twin, B3's with an alias-form
event, B4's), the JAX batch integrator with ``compact_mode="flat"``.
The sv-func rows of the jets are held against the JAX flat engine's
``jet_mode`` rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heyoka_tpu as hy
from heyoka_tpu.taylor import events_impl as jei

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.taylor import batch as pbatch
from heyoka_tpu_torch.taylor import events_impl as pei
from heyoka_tpu_torch.tools.cases import ROLLED_TEST_WIDTH, ROUTES, route_case

P = 8  # the test polynomials' degree
B, SEED, TOL, NSTEPS = 4, 3, 1e-9, 12
JETS = {"b2": "jet_plain", "b3": "jet_rolled_plain", "b4": "phase_plain"}


# -- the isolators and the refinement -----------------------------------------

def _poly(roots, scale=1.0, tail=()):
    """Ascending coefficients of ``scale * prod (s - r) * prod (s - t)``
    (``tail``: roots outside [0, 1]), padded to degree ``P``."""
    c = np.polynomial.polynomial.polyfromroots(list(roots) + list(tail))
    c = scale * c
    out = np.zeros(P + 1)
    out[:c.size] = c
    return out


def _polys():
    rng = np.random.default_rng(11)
    rows = [
        _poly([0.3, 0.7], tail=[1.8, -2.0]),
        _poly([0.3, 0.3], tail=[3.0]),              # a double root
        _poly([0.0, 0.6], tail=[-1.5]),             # a root at 0
        _poly([1.0, 0.25], tail=[2.5]),             # a root at 1
        _poly([0.41, 0.42], tail=[1.7]),            # a cluster in a leaf
        _poly([0.12, 0.121, 0.9], tail=[-3.0]),     # one more, and a root
        _poly([0.2, 0.45, 0.8], scale=-2.0, tail=[1.4, -1.1]),
        _poly([], tail=[1.5, -0.5]),                # none in [0, 1]
        _poly([0.6], tail=[0.6, 0.6]),              # a triple root
    ]
    for _ in range(15):
        n_in = rng.integers(0, 4)
        rows.append(_poly(rng.uniform(0, 1, n_in),
                          scale=rng.uniform(-3, 3),
                          tail=rng.uniform(1.1, 4.0, rng.integers(0, 3))
                          * rng.choice([-1, 1])))
    for _ in range(8):
        rows.append(rng.standard_normal(P + 1))
    return np.array(rows)


def _tree_both(cs):
    jt = jei._make_tree_isolator(P, jnp.float64, jei.MAX_ROOTS)
    pt = pei._make_tree_isolator(P, pei.MAX_ROOTS, "cpu")
    return ([np.asarray(x) for x in jt(jnp.asarray(cs))],
            [x.numpy() for x in pt(torch.as_tensor(cs))])


def test_tree_isolator_matches_jax():
    cs = _polys()
    j, p = _tree_both(cs)
    for a, b in zip(j, p):
        np.testing.assert_array_equal(a, b)
    fb = p[3]
    # the double and triple roots, the cluster in one leaf and the roots
    # at 0 and 1 (zero endpoints) fall back
    assert fb[[1, 2, 3, 4, 8]].all() and not fb[0]


def test_ca_isolator_matches_jax():
    cs = _polys()
    jca = jax.vmap(jei._make_isolator(P, jnp.float64, jei.MAX_ROOTS))
    pca = pei._make_isolator(P, pei.MAX_ROOTS, "cpu")
    rj = [np.asarray(x) for x in jca(jnp.asarray(cs))]
    rp = [x.numpy() for x in pca(torch.as_tensor(cs))]
    np.testing.assert_array_equal(rp[2], rj[2])
    for a, b in zip(rp[:2], rj[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)
    # the cluster in one leaf of the tree is split into two intervals
    assert rp[2][4].sum() == 2


def test_refine_roots_matches_jax():
    cs = _polys()
    j, p = _tree_both(cs)
    jca = jax.vmap(jei._make_isolator(P, jnp.float64, jei.MAX_ROOTS))
    rlo, rhi, val = (np.asarray(x) for x in jca(jnp.asarray(cs)))
    for lo, hi, v in ((j[0], j[1], j[2]), (rlo, rhi, val)):
        sj, vj, dj = (np.asarray(x) for x in jei._refine_roots(
            jnp.asarray(cs), jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(v)))
        sp, vp, dp = (x.numpy() for x in pei._refine_roots(
            torch.as_tensor(cs), torch.as_tensor(lo), torch.as_tensor(hi),
            torch.as_tensor(v)))
        np.testing.assert_array_equal(vp, vj)
        np.testing.assert_array_equal(dp[vp], dj[vj])
        np.testing.assert_allclose(sp[vp], sj[vj], rtol=0, atol=1e-14)
    # the simple roots of the first row, to the last bits
    np.testing.assert_allclose(np.sort(sp[0][vp[0]]), [0.3, 0.7], atol=1e-14)


@pytest.mark.parametrize("h", [0.37, -0.37])
def test_find_roots_matches_the_dense_path(h):
    # the port drops the rows that pass the exclusion test; the JAX
    # batch step (its f64 path at this size) runs them all
    cs = _polys()
    g = cs[None] / (h ** np.arange(P + 1))
    hh = np.full(1, h)
    fr = pei.make_find_roots(P, "cpu")
    sp, vp, dp = (x.numpy()[0] for x in fr(torch.as_tensor(g),
                                            torch.as_tensor(hh)))
    tree = jei._make_tree_isolator(P, jnp.float64, jei.MAX_ROOTS)
    ca = jax.vmap(jei._make_isolator(P, jnp.float64, jei.MAX_ROOTS))
    c = jnp.asarray(g[0] * (h ** np.arange(P + 1)))
    rlo, rhi, val, fb = tree(c)
    rc = ca(c)
    sel = fb[:, None]
    need = jnp.abs(c[:, 0]) <= jnp.sum(jnp.abs(c[:, 1:]), 1)
    sj, vj, dj = (np.asarray(x) for x in jei._refine_roots(
        c, jnp.where(sel, rc[0], rlo), jnp.where(sel, rc[1], rhi),
        jnp.where(sel, rc[2], val) & need[:, None]))
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_allclose(sp[vp], sj[vj], rtol=0, atol=1e-14)
    dj = np.where(h >= 0, dj, -dj)
    np.testing.assert_array_equal(dp[vp], dj[vj])


# -- the event step on the three routes ---------------------------------------

def _events(pkg, route, sys_):
    """``(t_events, nt_events)`` of a route, built with ``pkg``: b2 body 1
    crossing x = 0 (non-terminal) and y = 0 going down (terminal); b3 the
    alias-form x - 1.5 (non-terminal) and an impact on the unit sphere
    (terminal, never reached); b4 v = 0 (terminal) and x = 0."""
    names = [lhs.name for lhs, _ in sys_]

    def var(n):
        return pkg.make_vars(n)

    if route == "b2":
        x1, y1 = var(names[6]), var(names[7])
        return ([pkg.t_event(y1, direction=pkg.EventDirection.negative)],
                [pkg.nt_event(x1, None)])
    if route == "b3":
        x, y, z = (var(n) for n in names[:3])
        return ([pkg.t_event(x * x + y * y + z * z - 1.0)],
                [pkg.nt_event(x - 1.5, None)])
    x, v = (var(n) for n in names[:2])
    return [pkg.t_event(v)], [pkg.nt_event(x, None)]


@pytest.fixture(scope="module")
def jax_ev():
    cache = {}

    def get(route):
        if route not in cache:
            sys_, st = route_case(hy, route, B, SEED)
            te, nt = _events(hy, route, sys_)
            cache[route] = hy.taylor_adaptive_batch(
                sys_, st, compact_mode="flat", tol=TOL, high_accuracy=True,
                t_events=te, nt_events=nt)
        return cache[route]

    return get


def _port(route, monkeypatch, **kw):
    if route == "b3":
        monkeypatch.setattr(pbatch, "ROLLED_MIN_WIDTH", ROLLED_TEST_WIDTH)
    sys_, st = route_case(ht, route, B, SEED)
    te, nt = _events(ht, route, sys_)
    p = ht.taylor_adaptive_batch(sys_, st, tol=TOL, high_accuracy=True,
                                 device="cpu", t_events=te, nt_events=nt,
                                 **kw)
    assert p.engine_report()["jet"] == JETS[route]
    return p, st


@pytest.mark.parametrize("route", ROUTES)
def test_ev_step_matches_jax(jax_ev, monkeypatch, route):
    j = jax_ev(route)
    p, st = _port(route, monkeypatch)
    t_hi = np.zeros(B)
    t_lo = np.zeros(B)
    cd = np.zeros((B, 1))
    mdt = np.full(B, np.inf)
    pars = np.zeros((B, 0))
    n_hit = n_te = 0
    for _ in range(NSTEPS):
        rj = {k: np.asarray(v) for k, v in j._ev_step(
            jnp.asarray(st), jnp.asarray(pars), jnp.asarray(t_hi),
            jnp.asarray(t_lo), jnp.asarray(mdt), jnp.asarray(cd)).items()}
        rp = {k: v.numpy() for k, v in p._ev(*(torch.as_tensor(a) for a in (
            st, pars, t_hi, t_lo, mdt, cd))).items()}
        for k in ("outcome", "te_idx", "nt_mask", "nt_idx"):
            np.testing.assert_array_equal(rp[k], rj[k], err_msg=k)
        m = rj["nt_mask"]
        np.testing.assert_array_equal(rp["nt_sgn"][m], rj["nt_sgn"][m])
        np.testing.assert_allclose(rp["nt_times"][m], rj["nt_times"][m],
                                   rtol=0, atol=1e-13)
        hit = rj["te_idx"] >= 0
        np.testing.assert_array_equal(rp["te_sgn"][hit], rj["te_sgn"][hit])
        np.testing.assert_allclose(rp["cooldowns"], rj["cooldowns"],
                                   rtol=1e-11)
        np.testing.assert_allclose(rp["last_h"], rj["last_h"], rtol=1e-13)
        np.testing.assert_allclose(rp["t_hi"], rj["t_hi"], rtol=1e-13)
        scale = np.abs(rj["state"]).max()
        np.testing.assert_allclose(rp["state"], rj["state"], rtol=0,
                                   atol=1e-11 * scale)
        assert rp["tc"].shape == rj["tc"].shape
        n_hit += int(m.sum())
        n_te += int(hit.sum())
        st, t_hi, t_lo, cd = (rj[k] for k in ("state", "t_hi", "t_lo",
                                             "cooldowns"))
    # the steps cross the non-terminal event; on b2 and b4 the terminal one
    assert n_hit > 0 and (n_te > 0) == (route != "b3")


@pytest.mark.parametrize("route", ROUTES)
def test_plain_step_matches_the_event_step(monkeypatch, route):
    # without a root in the step, the step without isolation is the event
    # step; its raw event rows are the event columns of tc
    p, st = _port(route, monkeypatch)
    args = [torch.as_tensor(a) for a in (st, np.zeros((B, 0)), np.zeros(B),
                                         np.zeros(B), np.full(B, 1e-3))]
    r = p._ev(*args, torch.zeros((B, 1), dtype=torch.float64))
    q = p._ev.plain_step_b(*args)
    assert not r["nt_mask"].any() and (r["te_idx"] < 0).all()
    for k in ("state", "t_hi", "t_lo", "last_h", "tc", "outcome"):
        assert torch.equal(q[k], r[k]), k
    assert torch.equal(q["ev_row"], r["tc"][:, :, p.dim:].transpose(1, 2))


@pytest.mark.parametrize("route", ROUTES)
def test_event_rows_match_jax_jet_mode(jax_ev, monkeypatch, route):
    # the jets' sv-func rows: the twins of B2, B3 (the alias-form event
    # read through its root) and B4 against the JAX flat engine's
    # jet_mode rows (the tc of its event step, its flat_jet's), per order
    j = jax_ev(route)
    p, st = _port(route, monkeypatch)
    z = np.zeros(B)
    tcj = np.asarray(j._ev_step(*(jnp.asarray(a) for a in (
        st, np.zeros((B, 0)), z, z, np.full(B, np.inf),
        np.zeros((B, 1)))))["tc"])
    tcp, _ = (x.numpy() for x in p._ev.jet_b(
        torch.as_tensor(st), torch.zeros((B, 0), dtype=torch.float64),
        torch.as_tensor(z), torch.full((B,), np.inf, dtype=torch.float64)))
    assert tcp.shape == tcj.shape == (B, p.order + 1, p.dim + 2)
    scale = np.abs(tcj).max(axis=2, keepdims=True)
    np.testing.assert_allclose(tcp / scale, tcj / scale, rtol=0, atol=1e-13)
    if route == "b3":  # the alias-form event is x - 1.5, row 0 moved
        np.testing.assert_array_equal(tcp[:, 1:, p.dim + 1], tcp[:, 1:, 0])
        np.testing.assert_array_equal(tcp[:, 0, p.dim + 1],
                                      tcp[:, 0, 0] - 1.5)
