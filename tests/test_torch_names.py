"""The port's public names against the JAX package's: every public name
of ``heyoka_tpu`` and ``heyoka_tpu.models`` exists in the port, or stands
on the list below of names not ported yet, each with the ROADMAP item
that ports it.  A name that the port gains must leave the list.  The JAX
package's names are read in a fresh interpreter: a submodule that another
test imports (``heyoka_tpu.native_cg``) becomes an attribute of the
package in this one."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import heyoka_tpu as hy

import heyoka_tpu_torch as ht
import heyoka_tpu_torch.models as htm

A15, A22 = "A.15 numeric rest", "A.22 native"

#: top-level names of ``heyoka_tpu`` the port does not have yet
NOT_PORTED = {
    "EOPData": A15, "SWData": A15, "eop_data": A15, "sw_data": A15,
    "eop_sw": A15, "multiprec": A15, "s11n": A15,
    "native": A22,
}

#: the series slice's model names (ROADMAP A.14, ported)
_A14_MODELS = (
    "vsop2013 vsop2013_cartesian vsop2013_cartesian_icrf vsop2013_elliptic "
    "get_vsop2013_mus elp2000 elp2000_cartesian elp2000_cartesian_e2000 "
    "elp2000_cartesian_fk5 elp2000_spherical get_elp2000_mus iau2006")
_A15_MODELS = (
    "eo_dynamics eop "
    "sw frames dayfrac era erap gmst82 gmst82p pm_x pm_xp pm_y pm_yp dX dXp "
    "dY dYp Ap_avg Ap_avgp f107 f107p f107a_center81 f107a_center81p "
    "rot_fk5j2000_icrs rot_icrs_fk5j2000 rot_icrs_itrs rot_itrs_icrs "
    "rot_itrs_teme rot_teme_itrs state_from_rsw state_from_rsw_inertial "
    "state_to_rsw state_to_rsw_inertial")

#: names of ``heyoka_tpu.models`` the port does not have yet
MODELS_NOT_PORTED = {
    **{n: A15 for n in _A15_MODELS.split()},
}


@pytest.fixture(scope="module")
def jax_names():
    """The public names of ``heyoka_tpu`` and ``heyoka_tpu.models`` right
    after ``import heyoka_tpu``."""
    code = ("import json, heyoka_tpu as h, heyoka_tpu.models as m; print("
            "json.dumps({k: [n for n in dir(v) if not n.startswith('_')] "
            "for k, v in (('heyoka_tpu', h), ('models', m))}))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=root,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("jax_mod,port_mod,not_ported", [
    ("heyoka_tpu", ht, NOT_PORTED), ("models", htm, MODELS_NOT_PORTED)],
    ids=["heyoka_tpu", "models"])
def test_every_public_name_is_ported_or_listed(jax_names, jax_mod, port_mod,
                                               not_ported):
    names = jax_names[jax_mod]
    missing = [n for n in names if not hasattr(port_mod, n)
               and n not in not_ported]
    assert not missing, f"neither in the port nor listed: {missing}"
    ported = [n for n in not_ported if hasattr(port_mod, n)]
    assert not ported, f"ported, still listed: {ported}"
    stale = [n for n in not_ported if n not in names]
    assert not stale, f"listed, not in the JAX package: {stale}"


def test_this_slice_and_the_repaired_names():
    # the scalar integrator and the ensembles (ROADMAP A.19, A.9), and
    # the names ROADMAP C.3 found missing
    for n in ("taylor_adaptive", "TaylorAdaptive", "ensemble",
              "ensemble_propagate_until", "ensemble_propagate_for",
              "ensemble_propagate_grid", "ensemble_propagate_until_batch",
              "ensemble_propagate_for_batch",
              "ensemble_propagate_grid_batch", "sin", "logical_not",
              "select", "cbrt", "kepE", "kepF", "kepDE", "sum_expr",
              "function_decompose", "taylor_order_from_tol",
              "AngleReducer", "StepCallbackSet", "angle_reducer",
              # compiled functions and variational systems (A.13, A.20)
              "cfunc", "make_cfunc", "var_ode_sys", "VarArgs", "varsys",
              "diff", "diff_tensors", "dtens", "lagham", "lagrangian",
              "hamiltonian"):
        assert hasattr(ht, n) and n not in NOT_PORTED
    for n in ("cr3bp", "pcr3bp", "cr3bp_jacobi", "ffnn"):
        assert hasattr(ht.models, n) and n not in MODELS_NOT_PORTED
    assert isinstance(ht.time, ht.TimeExpr) and ht.time is ht.time_
    assert ht.__version__ == hy.__version__
    # the JAX rule on a host without an accelerator
    if not torch.cuda.is_available():
        assert ht.recommended_simd_size() == hy.recommended_simd_size() == 8
    x = ht.make_vars("x")
    assert repr(ht.sin(x)) == repr(hy.sin(hy.make_vars("x")))
    assert ht.taylor_order_from_tol(1e-15) == hy.taylor_order_from_tol(1e-15)


@pytest.mark.parametrize("dtype", [np.float64, "float64", torch.float64,
                                   np.dtype(np.float64)])
def test_float64_is_accepted(dtype):
    tb = ht.taylor_adaptive_batch(ht.models.pendulum(), [[0.1, 0.0]],
                                  device="cpu", dtype=dtype)
    ta = ht.taylor_adaptive(ht.models.pendulum(), [0.1, 0.0], device="cpu",
                            dtype=dtype)
    assert tb.state.dtype == ta.state.dtype == np.float64


@pytest.mark.parametrize("dtype", [np.float32, torch.float32, "float16",
                                   int])
def test_other_dtypes_are_refused(dtype):
    with pytest.raises(ValueError, match="float64"):
        ht.taylor_adaptive_batch(ht.models.pendulum(), [[0.1, 0.0]],
                                 device="cpu", dtype=dtype)
    with pytest.raises(ValueError, match="float64"):
        ht.taylor_adaptive(ht.models.pendulum(), [0.1, 0.0], device="cpu",
                           dtype=dtype)


def test_the_earth_orbit_slice():
    # the model library of ROADMAP A.21, the SGP4 part of A.15, and the
    # pure-Python helpers that came with them
    for n in ("np1body", "np1body_energy", "np1body_potential", "kepler",
              "kepler_to_cartesian", "cartesian_to_kepler", "lagrange_prop",
              "sh_gravity", "sh_gravity_acc", "sh_gravity_pot",
              "egm2008_acc", "egm2008_pot", "get_egm2008_CS",
              "get_egm2008_a", "get_egm2008_mu", "cart2geo", "geo2cart",
              "time_conversions", "delta_tdb_tt", "delta_tt_tai",
              "thermonets", "nrlmsise00_tn", "jb08_tn", "sgp4",
              "sgp4_propagator", "SGP4Propagator", "gpe_is_deep_space"):
        assert hasattr(ht.models, n) and n not in MODELS_NOT_PORTED
    for n in ("gp", "logging", "utils", "set_logger_level_trace",
              "set_logger_level_debug", "set_logger_level_info",
              "set_logger_level_warn", "set_logger_level_err"):
        assert hasattr(ht, n) and n not in NOT_PORTED
    assert hasattr(ht.utils, "parse_tle_file")
    assert hasattr(ht.utils, "jd_utc_to_tai")


def test_the_series_slice():
    # the ephemeris models of ROADMAP A.14 and the series op behind them
    for n in _A14_MODELS.split():
        assert hasattr(ht.models, n) and n not in MODELS_NOT_PORTED
    assert callable(ht.models.iau2006)
    for mod in (ht.models.vsop2013, ht.models.elp2000):
        assert mod.__name__.startswith("heyoka_tpu_torch.models.")
    from heyoka_tpu_torch.expr import series
    assert callable(series.trig_series) and callable(series.affine_in_time)
