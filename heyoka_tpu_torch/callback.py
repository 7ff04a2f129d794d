"""Step callbacks and the angle reducer.

The counterpart of ``heyoka_tpu/callback.py`` (reference: heyoka
``step_callback[_set]``, ``include/heyoka/step_callback.hpp``, and
``callback::angle_reducer``, ``src/callback/angle_reducer.cpp``): a
callback runs after every step, with an optional ``pre_hook`` run once
before a ``propagate_*`` starts; the angle reducer wraps selected angle
state variables into [0, 2pi).

Callbacks come in two kinds, as in the JAX package:

- *in-graph* callables ``cb(state, pars, t_hi, t_lo, h, tc) ->
  (new_state, keep)``, marked by an ``in_graph`` attribute or a
  ``pre_hook``: they run per lane, as the JAX package vmaps them
  (``heyoka_tpu/callback.py:55``, ``taylor/batch.py:1014-1022``): one
  lane's ``state (n,)``, ``pars (p,)``, ``tc (K+1, n')`` and the scalars
  ``t_hi``, ``t_lo`` and ``h``, with ``keep`` one bool.  Over a batch
  :func:`apply` evaluates them with ``torch.func.vmap``, so a callback
  must be written in tensor operations: Python control flow on a tensor's
  value cannot be vmapped (as JAX cannot trace it) and raises;
- *host* callables ``cb(tb) -> bool`` for the host-driven drivers.
"""

from __future__ import annotations

import math

import torch

__all__ = ["AngleReducer", "StepCallbackSet", "adapt_host_callback",
           "angle_reducer", "apply"]


def is_in_graph(callback) -> bool:
    """Whether ``callback`` is an in-graph step callback."""
    return getattr(callback, "in_graph", False) or hasattr(callback,
                                                           "pre_hook")


def _lane(callback):
    """``callback`` with its ``keep`` as a bool tensor, for ``vmap``."""
    def run(state, pars, t_hi, t_lo, h, tc):
        new_state, keep = callback(state, pars, t_hi, t_lo, h, tc)
        if not isinstance(keep, torch.Tensor):
            keep = torch.tensor(bool(keep), device=state.device)
        return new_state, keep.to(torch.bool)
    return run


def apply(callback, state, pars, t_hi, t_lo, h, tc):
    """Run the in-graph ``callback`` on every lane of a batch (``state (B,
    n)``, ``pars (B, p)``, ``t_hi``, ``t_lo``, ``h`` (B,), ``tc (B, K+1,
    n')``): per lane under ``torch.func.vmap``.  Returns ``(new_state (B,
    n), keep (B,) bool)``."""
    try:
        new_state, keep = torch.func.vmap(_lane(callback))(
            state, pars, t_hi, t_lo, h, tc)
    except RuntimeError as e:
        if "data-dependent control flow" not in str(e):
            raise
        raise RuntimeError(
            "an in-graph step callback runs per lane under torch.func.vmap "
            "and cannot branch on a tensor's value (use torch.where), as "
            "the JAX package cannot trace it") from e
    return new_state, keep


def adapt_host_callback(tb, callback):
    """An in-graph ``callback`` in the host drivers' signature ``cb(tb) ->
    bool``: applied per lane (:func:`apply`) to the integrator's tensors
    after each step, its state written back and its ``keep`` reduced with
    *all* (a step callback that returns False stops the whole
    propagation, ``step_callback.hpp``).  Runs its ``pre_hook`` first.  A
    host callback (or None) comes back unchanged."""
    if callback is None or not is_in_graph(callback):
        return callback
    if hasattr(callback, "pre_hook"):
        callback.pre_hook(tb)

    def host_cb(t):
        new_state, keep = apply(callback, t._state, t._pars, t._t_hi,
                                t._t_lo, t._last_h, t._tc)
        t._state = new_state.contiguous()
        return bool(keep.all())

    return host_cb


class StepCallbackSet:
    """Run several in-graph step callbacks in order, on one lane; the lane
    goes on only if all of them keep it (reference
    ``step_callback_set``)."""

    def __init__(self, *callbacks):
        self._cbs = list(callbacks)

    def pre_hook(self, ta):
        for cb in self._cbs:
            if hasattr(cb, "pre_hook"):
                cb.pre_hook(ta)

    def __call__(self, state, pars, t_hi, t_lo, h, tc):
        keep = torch.tensor(True, device=state.device)
        for cb in self._cbs:
            state, k = _lane(cb)(state, pars, t_hi, t_lo, h, tc)
            keep = keep & k
        return state, keep


class AngleReducer:
    """Reduce selected state variables into [0, 2pi) after every step
    (reference ``callback::angle_reducer``), on one lane.  Construct with
    the variable names (or indices), then pass as the ``callback=`` of
    ``propagate_*``.
    """

    def __init__(self, vars):
        self._vars = list(vars)
        self._idx = None

    def _resolve(self, var_names):
        idx = []
        for v in self._vars:
            if isinstance(v, int):
                idx.append(v)
            else:
                name = v if isinstance(v, str) else v.name
                if name not in var_names:
                    raise ValueError(
                        f"angle_reducer: {name!r} is not a state variable")
                idx.append(var_names.index(name))
        if not idx:
            raise ValueError("angle_reducer: empty variable selection")
        self._idx = idx

    def pre_hook(self, ta):
        self._resolve(ta.decomposition.var_names)

    def __call__(self, state, pars, t_hi, t_lo, h, tc):
        if self._idx is None:
            raise RuntimeError(
                "angle_reducer used without pre_hook (pass it as a"
                " propagate callback, or call pre_hook(ta) first)")
        twopi = 2.0 * math.pi
        sel = torch.zeros(state.shape[-1], dtype=torch.bool,
                          device=state.device)
        sel[self._idx] = True
        return torch.where(sel, state - twopi * torch.floor(state / twopi),
                           state), True


def angle_reducer(vars) -> AngleReducer:
    return AngleReducer(vars)
