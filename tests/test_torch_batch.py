"""The slice end to end: the port's ``taylor_adaptive_batch`` against the
JAX package's (``compact_mode="flat", high_accuracy=True``), on the CPU in
f64.  The same calls through kernels B1 and B2 are in
tests/test_torch_gpu.py."""

import numpy as np
import pytest

import heyoka_tpu as hy

import heyoka_tpu_torch as ht
from heyoka_tpu_torch.taylor import jet_kernels as jk

B = 6
MASSES = [1.0, 1e-3, 2e-3]
BASE = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0,
                 0, 1.5, 0, -0.8, 0, 0], float)


def _nbody3(m):
    return m.models.nbody(3, masses=MASSES)


def _timedep(m):
    # non-autonomous, with div, sqrt and a parameter: propagates through
    # the per-step driver (kernel B1 carries no time)
    x, y = m.make_vars("x", "y")
    return [(x, y), (y, -x / m.sqrt(1.0 + x * x) + m.par[0] * m.time_)]


def _lanes(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "nbody3":
        return BASE[None] + 0.01 * rng.standard_normal((B, 18)), None
    return rng.uniform(-1, 1, (B, 2)), rng.uniform(0.01, 0.05, (B, 1))


SYSTEMS = {"nbody3": _nbody3, "timedep": _timedep}


def _pair(name, tol=1e-12, seed=0, high_accuracy=True):
    st, pars = _lanes(name, seed)
    kw = dict(tol=tol, high_accuracy=high_accuracy, pars=pars)
    j = hy.taylor_adaptive_batch(SYSTEMS[name](hy), st, compact_mode="flat",
                                 **kw)
    p = ht.taylor_adaptive_batch(SYSTEMS[name](ht), st, device="cpu", **kw)
    return j, p


def _main_steps(ns, last_h, t):
    """nsteps without a final sub-ulp landing step (see test_torch_prop)."""
    return np.asarray(ns) - (np.abs(last_h) < 4 * np.spacing(np.abs(t)))


@pytest.mark.parametrize("high_accuracy", [True, False])
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_step_matches_jax(name, high_accuracy):
    j, p = _pair(name, high_accuracy=high_accuracy)
    assert p.order == j.order and p.dim == j.dim
    for mdt in (None, 0.05, -0.05):
        j.step(max_delta_t=mdt)
        p.step(max_delta_t=mdt)
        assert [o for o, _ in p.get_step_res()] == \
            [o for o, _ in j.get_step_res()]
        np.testing.assert_allclose([h for _, h in p.get_step_res()],
                                   [h for _, h in j.get_step_res()],
                                   rtol=1e-13)
        np.testing.assert_allclose(p.state, j.state, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(p.time, j.time, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(p.tc, j.tc, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_propagate_until_matches_jax(name):
    j, p = _pair(name, seed=1)
    rj = j.propagate_until(5.0)
    rp = p.propagate_until(5.0)
    assert rp[0] == rj[0] and all(o == ht.TaylorOutcome.time_limit
                                  for o in rp[0])
    assert (p.time == 5.0).all() and (p.dtime[0] == 5.0).all()
    np.testing.assert_array_equal(_main_steps(rp[3], p.last_h, p.time),
                                  _main_steps(rj[3], j.last_h, j.time))
    np.testing.assert_allclose(rp[2], rj[2], rtol=1e-11)
    scale = np.abs(j.state).max()
    np.testing.assert_allclose(p.state, j.state, rtol=0, atol=1e-11 * scale)
    assert [r[0] for r in p.get_propagate_res()] == rp[0]
    # propagate_for, backward
    rj = j.propagate_for(-2.0)
    rp = p.propagate_for(-2.0)
    assert rp[0] == rj[0]
    assert (p.time == 3.0).all()
    np.testing.assert_allclose(p.state, j.state, rtol=0, atol=1e-11 * scale)


def test_step_limit_matches_jax():
    j, p = _pair("nbody3", seed=2)
    rj = j.propagate_until(100.0, max_steps=3)
    rp = p.propagate_until(100.0, max_steps=3)
    assert all(o == ht.TaylorOutcome.step_limit for o in rp[0])
    assert rp[0] == rj[0]
    np.testing.assert_array_equal(rp[3], 3)
    np.testing.assert_allclose(p.time, j.time, rtol=1e-13)
    np.testing.assert_allclose(p.state, j.state, rtol=0, atol=1e-12)


def test_engine_report():
    _, p = _pair("nbody3")
    # the shape B1/B2 would run on the card at the batch's lanes: the jets
    # in shared memory, one lane of 32 threads a block (27 rows); at order
    # 15, 12,672 B a lane: 17 an SM (the tables would cost two)
    assert p.order == 15
    smem = 8 * ((p.order + 1) * 98 + jk.LANE_SCALARS)
    assert p.engine_report() == dict(
        device="cpu", jet="jet_plain", propagate_engine="fused",
        prop="prop_plain", grid_engine="flat", c_output_engine="flat",
        layout=dict(layout="smem", lanes_per_block=1, smem_bytes=smem,
                    tables="global", threads=32, blocks_per_sm=17,
                    lanes_per_sm=17, waves=1))
    _, q = _pair("timedep")
    assert q.engine_report()["propagate_engine"] == "flat"
    assert q.engine_report()["prop"] is None


def test_state_from_numpy_carries_a_jax_integrator():
    # a JAX integrator's lanes, mid-flight, continue in the port
    j, _ = _pair("nbody3", seed=3)
    j.propagate_until(1.5)
    lanes = ht.state_from_numpy(j.state, j.pars, *j.dtime, "cpu")
    p = ht.taylor_adaptive_batch(_nbody3(ht), lanes["state"].numpy(),
                                 time=lanes["t_hi"].numpy(), tol=1e-12,
                                 high_accuracy=True, device="cpu")
    rj = j.propagate_until(3.0)
    rp = p.propagate_until(3.0)
    assert rp[0] == rj[0]
    np.testing.assert_allclose(p.state, j.state, rtol=0, atol=1e-11)
