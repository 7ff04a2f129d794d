"""Compiled functions (cfunc): a vector function of expressions evaluated
in torch on a device, in float64 or float32.

The counterpart of ``heyoka_tpu/cfunc.py`` (reference: heyoka ``cfunc<T>``,
``include/heyoka/expression.hpp:734-965``, ``src/cfunc_class.cpp``).  The
expressions are decomposed once (``expr.decompose.function_decompose``,
the same tape as the JAX package's) and evaluated row by row with the
rules of :mod:`.expr.numeric` (``pow`` with the JAX package's special
cases, ``taylor.jet_kernels._pow0_plain``) in the cfunc's dtype, float64
or float32, as the JAX class evaluates its tape in its own
(``cfunc.py:70-73``): one torch op per tape row over all the evaluations
at once.  Where the JAX class jits the tape and
``vmap``s it over the evaluations (``cfunc.py:109-146``), the rows here
broadcast over a leading evaluation axis: ``inputs`` (n_evals, n_vars),
``pars`` (n_pars,) shared or (n_evals, n_pars) per evaluation, ``time`` a
scalar or (n_evals,).

A dense trig-series op (``expr/series.py``) is one tape row too: kernel
S1 at order 0 over every evaluation on the card, its twin by chunks of
terms on the CPU (``taylor.series_jet.series_value``), never an
``(n_evals, n_terms)`` tensor.

Every tensor lives on the cfunc's ``device`` (CUDA unless the caller asks
for the CPU); results are tensors there.  Numpy arrays and lists are
copied to the device; a tensor on another device raises ``ValueError``,
nothing is moved quietly.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from .convert import check_dtype, numpy_dtype, resolve_device
from .expr.decompose import Tape, function_decompose
from .expr.numeric import evaluate
from .taylor.jet_kernels import _pow0_plain


def tape_eval(tape: Tape, inputs, pars, t):
    """Order 0 of a decomposed tape (the JAX ``tape_eval``, ``cfunc.py:
    27``): ``inputs`` (..., n_vars) and ``pars`` (..., n_pars) tensors of
    one dtype (f64 or f32), which every row keeps, ``t`` a tensor
    broadcastable against their leading axes; returns the tape's outputs,
    one tensor each (a literal output a 0-d tensor)."""
    n_eq = tape.n_eq
    vals = [inputs[..., i] for i in range(n_eq)]

    def G(operand):
        kind = operand[0]
        if kind == "c":
            # a fill on the device, not a copy from the host
            return inputs.new_full((), operand[1])
        if kind == "p":
            return pars[..., operand[1]]
        if kind == "t":
            return t
        return vals[operand[1]]

    for op in tape.ops:
        iv = [G(b) for b in op.inputs]
        if op.op == "mul":
            r = iv[0] * iv[1]
        elif op.op == "pow":
            r = _pow0_plain(iv[0], op.meta["alpha"])
        else:
            r = evaluate(op.op, *iv)
        vals.append(r)
    return [G(o) for o in tape.outputs]


class cfunc:
    """Compiled vector function of expressions (heyoka ``cfunc``).

    ``cf(inputs, pars=None, time=0.0)``: single evaluation with
    ``inputs`` (n_vars,) gives (n_outs,); multi evaluation with (n_evals,
    n_vars) gives (n_evals, n_outs), ``pars`` (n_pars,) or (n_evals,
    n_pars), ``time`` a scalar or (n_evals,).  ``vars`` fixes the input
    order (default: the sorted variable names); ``dtype``: float64 (the
    default) or float32, the dtype of the evaluation and of its results.
    """

    def __init__(self, fns, vars=None, *, dtype=np.float64, device="cuda"):
        self._tdtype = check_dtype(dtype)
        self.tape = function_decompose(fns, vars)
        self.fns = list(fns)
        self.dtype = numpy_dtype(self._tdtype)
        self.device = resolve_device(device)

    @property
    def vars(self) -> list:
        """The input variable names, in order (reference ``get_vars``)."""
        return list(self.tape.var_names)

    @property
    def fn(self) -> list:
        """The compiled expressions (reference ``get_fn``)."""
        return list(self.fns)

    @property
    def dc(self):
        """The decomposition tape (reference ``get_dc``)."""
        return self.tape

    @property
    def n_vars(self) -> int:
        return self.tape.n_eq

    @property
    def n_outs(self) -> int:
        return len(self.tape.outputs)

    @property
    def n_pars(self) -> int:
        return self.tape.n_pars

    def _tensor(self, x, what):
        """``x`` as a tensor of the cfunc's dtype on its device; a tensor
        elsewhere raises."""
        if isinstance(x, torch.Tensor):
            dev = self.device
            if x.device.type != dev.type or dev.index not in (
                    None, x.device.index):
                raise ValueError(
                    f"{what} lies on {x.device}, the cfunc on {self.device}")
            return x.to(self._tdtype)
        return torch.as_tensor(np.array(x, self.dtype), device=self.device)

    def __call__(self, inputs, pars=None, time=0.0):
        inputs = self._tensor(inputs, "inputs")
        if inputs.ndim not in (1, 2) or inputs.shape[-1] != self.n_vars:
            raise ValueError(f"inputs must be ({self.n_vars},) or (n_evals, "
                             f"{self.n_vars}); got {tuple(inputs.shape)}")
        lead = inputs.shape[:-1]
        # a scalar time and the default parameters are fills on the
        # device, not copies from the host
        pars = inputs.new_zeros(self.n_pars) if pars is None \
            else self._tensor(pars, "pars")
        if pars.shape not in ((self.n_pars,), (*lead, self.n_pars)):
            raise ValueError(f"pars must be ({self.n_pars},) or (n_evals, "
                             f"{self.n_pars}); got {tuple(pars.shape)}")
        t = inputs.new_full((), float(time)) \
            if isinstance(time, numbers.Real) else self._tensor(time, "time")
        if t.shape not in ((), lead):
            raise ValueError("time must be a scalar or have shape (n_evals,)")
        outs = tape_eval(self.tape, inputs, pars, t)
        return torch.stack([o.expand(lead) for o in outs], -1)

    def __getstate__(self):
        return {"fns": self.fns, "vars": self.tape.var_names,
                "dtype": self.dtype.name, "device": str(self.device)}

    def __setstate__(self, st):
        """Rebuild on the pickled device (raises where it is absent)."""
        self.__init__(st["fns"], vars=st["vars"], dtype=st["dtype"],
                      device=st["device"])

    def __repr__(self):
        return (f"cfunc(n_vars={self.n_vars}, n_outs={self.n_outs}, "
                f"n_pars={self.n_pars}, dtype={self.dtype.name}, "
                f"device={self.device})")


def make_cfunc(fns, vars=None, **kw) -> cfunc:
    """Factory mirroring heyoka's ``cfunc<T>`` ctor / ``add_cfunc``."""
    return cfunc(fns, vars, **kw)
