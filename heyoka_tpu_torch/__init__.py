"""heyoka_tpu_torch — the PyTorch/CUDA port of heyoka_tpu.

Imports torch and numpy, never JAX: the expression layer and the tape
planner are copies of ``heyoka_tpu``'s pure-Python modules, held against
the originals by the tests.  Everything runs in f64 (or f32 where the
caller asks) on an explicit ``device``: a CPU tensor runs the plain torch
versions, a CUDA tensor the hand-written CUDA kernels of ``csrc/`` (built
with ``nvcc`` at first use).

The port covers the scalar and batch integrators and the ensembles
(``taylor_adaptive``, ``taylor_adaptive_batch``,
``ensemble_propagate_*``) with terminal and non-terminal events and step
callbacks (``step``, ``propagate_until``/``propagate_for`` with
continuous output, ``propagate_grid``, the dense output of the last step,
pickling; ``AngleReducer``, ``StepCallbackSet``): tapes
made of sum, mul, div, sqrt and pow — the outer-Solar-System N-body workload (kernels B1, B2) and
huge instance-regular tapes such as mascons (kernel B3) — and tapes with
any other op of the recurrence rule set (trig, hyperbolic, Kepler,
relational ...), such as the pendulum, through the phase jet (kernel B4).
Variational systems (``var_ode_sys``, ``VarArgs``, over ``diff`` and
``diff_tensors``; ``lagrangian``/``hamiltonian``) are augmented ODE
systems on the same routes, and compiled functions (``cfunc``,
``make_cfunc``) evaluate expressions in f64 torch on the device.
The Earth-orbit model library (``models``: ``np1body``, the Kepler
helpers, ``sh_gravity``/``egm2008_*``, ``cart2geo``, the time
conversions, the thermoNET densities on the port's copies of the data,
and the batched ``SGP4Propagator`` over a compiled function) and
``utils`` (time scales, TLE parsing), ``gp`` and ``logging`` are copies
of the JAX package's, and so are the ephemeris models (``vsop2013``,
``elp2000``, ``iau2006``) and the dense trig-series op behind them
(``expr.series``), whose Taylor jet is kernel S1 (``csrc/series_jet.cu``)
before B4 runs the rest of such a tape.  The Earth-orientation and
space-weather tables (``eop_sw``: ``EOPData``, ``SWData`` on the port's
copies of the builtin snapshots) give data-driven interpolation ops whose
order 0 runs in torch and whose higher orders are kernel B4 rules; on
them stand the frame rotations of the IAU2006 chain and the full
``models.eo_dynamics``.

Integrators, cfuncs and the SGP4 propagator take ``dtype=float64`` (the
default) or ``float32``: a float32 integrator runs every tape through
kernel B4's f32 entry.  ``s11n`` pickles every object and manages the
kernel library's directory as the JAX package's cache API manages its
compilation cache; ``multiprec`` is the host-side mpmath integrator at any
number of digits (it imports mpmath at first use).  ``native`` is the JAX
package's C++ host runtime (``native_cg`` its compiled stepper), behind
``backend="native"`` of both integrators: built with ``g++`` at first
use, it runs on the host CPU and never on the card.
"""

from .expr.core import (  # noqa: F401
    Expr,
    Number,
    Variable,
    Param,
    TimeExpr,
    Func,
    make_vars,
    par,
    time as time_,
    subs,
    rename_variables,
    get_variables,
    get_params,
    is_time_dependent,
)
from .expr import math  # noqa: F401
from .expr.math import (  # noqa: F401
    sin, cos, tan, asin, acos, atan, atan2,
    sinh, cosh, tanh, asinh, acosh, atanh,
    exp, log, sqrt, cbrt, erf, sigmoid, relu, relup,
    kepE, kepF, kepDE, sum_ as sum_expr, sum_, sum_sq, prod, pi, select,
    lt, gt, le, ge, eq, ne, logical_and, logical_or, logical_not,
)
from .expr.decompose import (  # noqa: F401
    function_decompose, taylor_decompose_sys,
)
from .expr.diff import diff  # noqa: F401
from .expr.dtens import diff_tensors, dtens  # noqa: F401
from .cfunc import cfunc, make_cfunc  # noqa: F401
from . import lagham, varsys  # noqa: F401
from .lagham import hamiltonian, lagrangian  # noqa: F401
from .varsys import VarArgs, var_ode_sys  # noqa: F401
from .taylor.stepper import taylor_order_from_tol  # noqa: F401
from . import eop_sw  # noqa: F401
from .eop_sw import EOPData, SWData, eop_data, sw_data  # noqa: F401
from . import models  # noqa: F401
from . import gp, logging, utils  # noqa: F401
from .logging import (  # noqa: F401
    set_logger_level_trace,
    set_logger_level_debug,
    set_logger_level_info,
    set_logger_level_warn,
    set_logger_level_err,
)
from .convert import (  # noqa: F401
    JET_OPS, OPCODES, PHASE_OPS, UnsupportedKernelOp, plan_from_arrays,
    plan_to_arrays, state_from_numpy,
)
from .taylor.adaptive import TaylorAdaptive, taylor_adaptive  # noqa: F401
from .taylor.batch import TaylorAdaptiveBatch, taylor_adaptive_batch  # noqa: F401
from .taylor.continuous import ContinuousOutput, ContinuousOutputBatch  # noqa: F401
from .taylor.outcome import TaylorOutcome  # noqa: F401
from .taylor.events import EventDirection, nt_event, t_event  # noqa: F401
from . import callback  # noqa: F401
from .callback import AngleReducer, StepCallbackSet, angle_reducer  # noqa: F401
from . import ensemble  # noqa: F401
from .ensemble import (  # noqa: F401
    ensemble_propagate_until,
    ensemble_propagate_for,
    ensemble_propagate_grid,
    ensemble_propagate_until_batch,
    ensemble_propagate_for_batch,
    ensemble_propagate_grid_batch,
)
from .taylor.jet_kernels import LAUNCHES  # noqa: F401
from . import multiprec, native, s11n  # noqa: F401
from .taylor.jet_phase import PhaseTape, jet_phase, phase  # noqa: F401

taylor_outcome = TaylorOutcome
time = time_

#: the JAX package's version string, which the port's API follows
__version__ = "0.1.0"


def recommended_simd_size(dtype=None) -> int:
    """The batch width the JAX package recommends (heyoka's
    ``recommended_simd_size<T>()``, ``llvm_state.hpp:88-110``) under its
    rule (``heyoka_tpu/__init__.py:86-108``): 8 on a host without an
    accelerator, 128 where one is attached (here: a CUDA device);
    ``dtype`` is accepted for the API's sake."""
    import torch

    return 128 if torch.cuda.is_available() else 8
