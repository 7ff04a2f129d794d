"""heyoka_tpu_torch — the PyTorch/CUDA port of heyoka_tpu.

Imports torch and numpy, never JAX: the expression layer and the tape
planner are copies of ``heyoka_tpu``'s pure-Python modules, held against
the originals by the tests.  Everything runs in f64 on an explicit
``device``: a CPU tensor runs the plain torch versions, a CUDA tensor the
hand-written CUDA kernels of ``csrc/`` (built with ``nvcc`` at first use).

The port covers the batch integrator with terminal and non-terminal
events and step callbacks (``step``, ``propagate_until``/
``propagate_for`` with continuous output, ``propagate_grid``, the dense
output of the last step, pickling; ``callback.AngleReducer``): tapes
made of sum, mul, div, sqrt and pow — the outer-Solar-System N-body workload (kernels B1, B2) and
huge instance-regular tapes such as mascons (kernel B3) — and tapes with
any other op of the recurrence rule set (trig, hyperbolic, Kepler,
relational ...), such as the pendulum, through the phase jet (kernel B4).
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
from .expr.math import sqrt, sum_, sum_sq, prod, pi  # noqa: F401
from .expr.decompose import taylor_decompose_sys  # noqa: F401
from . import models  # noqa: F401
from .convert import (  # noqa: F401
    JET_OPS, OPCODES, PHASE_OPS, UnsupportedKernelOp, plan_from_arrays,
    plan_to_arrays, state_from_numpy,
)
from .taylor.batch import TaylorAdaptiveBatch, taylor_adaptive_batch  # noqa: F401
from .taylor.continuous import ContinuousOutput, ContinuousOutputBatch  # noqa: F401
from .taylor.outcome import TaylorOutcome  # noqa: F401
from .taylor.events import EventDirection, nt_event, t_event  # noqa: F401
from . import callback  # noqa: F401
from .taylor.jet_kernels import LAUNCHES  # noqa: F401
from .taylor.jet_phase import PhaseTape, jet_phase, phase  # noqa: F401

taylor_outcome = TaylorOutcome
