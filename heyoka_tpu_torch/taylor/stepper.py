"""Adaptive step rules over a batch of lanes, in torch, in the dtype of
the coefficients (f64, or f32 for a float32 integrator).

The counterpart of ``heyoka_tpu.taylor.stepper`` (reference: heyoka
``src/taylor_00.cpp``, ``taylor_determine_h`` :102-273,
``taylor_run_multihorner`` :279, ``taylor_run_ceval`` :355;
``taylor_order_from_tol``, ``detail/taylor_common.hpp:165-191``).

The JAX functions take one trajectory and are ``vmap``-ed; here the lane
axis is written out as the LAST axis: ``tc`` is ``(order+1, n, B)`` and
``h`` is ``(B,)``.  The same formulas run inside the CUDA kernel
``csrc/taylor_jet.cu`` (``rho_h`` and ``ceval`` there).
"""

from __future__ import annotations

import math as _pymath

import torch


def taylor_order_from_tol(tol: float) -> int:
    """order = max(2, ceil(-log(tol)/2 + 1)) (Jorba; ``taylor_common.hpp:165``)."""
    tol = float(tol)
    if not (tol > 0.0) or not _pymath.isfinite(tol):
        raise ValueError("the tolerance must be a positive finite number")
    order_f = _pymath.ceil(-_pymath.log(tol) / 2.0 + 1.0)
    return int(max(2, order_f))


def rho_factor(order: int) -> float:
    """Jorba's scaling + safety factor exp(-7/10 / (order-1)) / e^2."""
    return _pymath.exp(-0.7 / (order - 1)) / (_pymath.e * _pymath.e)


def h_from_norms(m0, mo1, mo, order: int, max_delta_t):
    """Signed step size from the per-lane infinity norms of orders 0,
    ``order - 1`` and ``order`` (each ``(B,)``), in their dtype.
    ``max_delta_t`` (``(B,)`` or scalar) may be negative: the step then
    goes backward.  An order-K norm that underflows to 0 gives an infinite
    rho, which the other order or ``max_delta_t`` bounds, as in the JAX
    package's ``determine_h`` (``stepper.py:33-64``), which guards neither
    in f64 nor in f32."""
    num = torch.where(m0 <= 1.0, torch.ones_like(m0), m0)
    rho = torch.minimum((num / mo) ** (1.0 / order),
                        (num / mo1) ** (1.0 / (order - 1)))
    max_h = torch.as_tensor(max_delta_t, dtype=m0.dtype, device=m0.device)
    h = torch.minimum(rho * rho_factor(order), torch.abs(max_h))
    return torch.where(max_h < 0.0, -h, h)


def determine_h(tc, order: int, n_eq: int, max_delta_t):
    """Adaptive timestep from the jet ``tc (order+1, >= n_eq, B)``, Jorba's
    prescription; the norms run over every column of ``tc`` (state
    variables and sv-funcs), like the reference (``taylor_00.cpp:168-190``)."""
    abs_tc = torch.abs(tc)
    return h_from_norms(abs_tc[0].amax(0), abs_tc[order - 1].amax(0),
                        abs_tc[order].amax(0), order, max_delta_t)


def horner_update(tc, h, order: int, n_eq: int):
    """New state ``(n_eq, B)`` via Horner evaluation of the Taylor
    polynomials (``taylor_run_multihorner``)."""
    res = tc[order, :n_eq]
    for i in range(1, order + 1):
        res = tc[order - i, :n_eq] + res * h
    return res


def horner(tc_at, x, order: int):
    """``sum_i c_i x^i`` by Horner (``tc[K] ... + res * x``, the JAX
    package's dense-output order), ``tc_at(i)`` the order-i coefficients,
    broadcast against ``x[..., None]``: the dense output of a step, of the
    grid driver and of the continuous output."""
    res = tc_at(order)
    for i in range(1, order + 1):
        res = tc_at(order - i) + res * x[..., None]
    return res


def ceval_update(tc, h, order: int, n_eq: int):
    """New state ``(n_eq, B)`` via compensated-summation monomial
    evaluation — the ``high_accuracy`` mode (``taylor_run_ceval``)."""
    res = tc[0, :n_eq]
    comp = torch.zeros_like(res)
    cur_h = h
    for i in range(1, order + 1):
        tmp = tc[i, :n_eq] * cur_h
        y = tmp - comp
        t = res + y
        comp = (t - res) - y
        res = t
        if i < order:
            cur_h = cur_h * h
    return res
