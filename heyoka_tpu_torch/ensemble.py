"""Ensemble propagation: many customized instances of one integrator.

The counterpart of ``heyoka_tpu/ensemble.py`` (reference: heyoka
``ensemble_propagate_until/for/grid``, ``include/heyoka/
ensemble_propagate.hpp:108-269``): ``n_iter`` instances of a template
integrator, each given its ``state``, ``pars`` and ``time`` by ``gen``
(``gen(i) -> dict`` of overrides, or a dict of stacked arrays), are
propagated and their results returned as a dict of stacked tensors on the
template's device (``state``, ``time``, ``outcome``, ``min_h``, ``max_h``,
``nsteps``; ``out`` for the grid).

On one card an ensemble is one batch: the instances are the lanes of one
:class:`.taylor.batch.TaylorAdaptiveBatch` of the template's system,
tolerance, ``high_accuracy`` and events, which runs the route the template
runs (kernel B1 with B2 for the landings on an event-free tape of sum,
mul, div, sqrt and pow, the per-step driver over B2, B3 or B4 otherwise).
The batch shares the template's jet tape and drivers
(``TaylorAdaptiveBatch._sharing``), so no call decomposes or packs the
tape again; on another device of ``mesh`` the packed tables are loaded
there once and kept on the template (the counterpart of the JAX
``_ens_cache``, ``ensemble.py:83``).  The template is left as it was.  A
variational template's batch keeps its ``var_ode_sys`` (``_sharing``
copies it, as the JAX fallbacks' ``deepcopy`` does, ``ensemble.py:481,
522``): the instances' states are augmented states, sliced by the
template's ``get_vslice``.

Events: with pure-stop terminal events and non-terminal events the batch
runs its event driver (``events.propagate_until_ev``); the results gain
``te_idx``, ``te_sgn`` and the non-terminal hits ``nt_times``, ``nt_idx``,
``nt_sgn`` (padded with NaN, -1 and 0) and ``nt_count``, and the
non-terminal callbacks are then called on the host as ``cb(results, t,
d_sgn, instance)``, in time order within each instance
(``ensemble.py:440-460``).  Terminal events with callbacks, and grids over
any events, take the per-instance host fallback, as in JAX
(``_ensemble_propagate_until_host_ev`` :462,
``_ensemble_propagate_grid_host_ev`` :568): one working copy of the
template propagates each instance in turn, O(n_iter) propagations.

``mesh``: the counterpart of the JAX ``Mesh`` is a sequence of torch
devices (or their names).  The instances are split into equal contiguous
shards (``n_iter`` divisible by its length, as in JAX), each shard a
batch on its device, run one after another, and the results are
concatenated on the first device.  The host fallbacks run on the
template's device.  The JAX package's multi-device ``shard_map`` and
multi-host meshes have no counterpart here.

The ``_batch`` variants take a batch template and flatten ``(n_iter, B)``
instances into ``n_iter * B`` lanes, then reshape the results back
(``ensemble.py:721-797``).
"""

from __future__ import annotations

import math as _pymath

import numpy as np
import torch

from .convert import resolve_device
from .taylor.adaptive import TaylorAdaptive
from .taylor.batch import TaylorAdaptiveBatch
from .taylor.events import nt_event, t_event
from .taylor.outcome import TaylorOutcome

__all__ = ["ensemble_propagate_until", "ensemble_propagate_for",
           "ensemble_propagate_grid", "ensemble_propagate_until_batch",
           "ensemble_propagate_for_batch", "ensemble_propagate_grid_batch"]


class _BatchTemplate:
    """A batch integrator as the ensembles' template: its lanes are
    ``n_iter * B`` instances, lane 0 gives the defaults."""

    def __init__(self, tab):
        self._tb = self._tab = tab
        self.dim = tab.dim
        self.t_events, self.nt_events = tab.t_events, tab.nt_events
        self.state = tab.state[0]
        self.pars = tab.pars[0]
        self.time = float(tab.time[0])


def _engine(ta, device):
    """The batch whose jet tape and drivers the ensemble's batch on
    ``device`` shares: the template's own, or one built once on another
    device and kept on the template's batch."""
    src = ta._tb
    if device == src._device:
        return src
    cache = src.__dict__.setdefault("_ens_engines", {})
    key = str(device)
    if key not in cache:
        cache[key] = TaylorAdaptiveBatch._sharing(
            src, src.state[:1], pars=src.pars[:1], time=src.time[:1],
            device=device)
    return cache[key]


def _build_inputs(ta, n_iter, gen):
    """Per-instance ``(state, pars, time)`` numpy arrays from ``gen``
    (``ensemble.py:30-64``): a dict of stacked arrays (``pars`` default
    zeros, ``time`` the template's), or ``gen(i) -> dict`` overriding the
    template's ``state``, ``pars`` and ``time`` for instance ``i``."""
    dim, n_pars = ta.dim, ta._tb.decomposition.n_pars
    npd = ta._tb.dtype
    if isinstance(gen, dict):
        states = np.asarray(gen.get("state"), dtype=npd)
        pars = gen.get("pars")
        pars = np.zeros((n_iter, n_pars), npd) if pars is None else \
            np.asarray(pars, npd).reshape(n_iter, n_pars)
        times = gen.get("time")
        times = np.full((n_iter,), ta.time, npd) if times is None else \
            np.array(np.broadcast_to(np.asarray(times, npd),
                                     (n_iter,)))
        return states, pars, times
    states = np.empty((n_iter, dim), npd)
    pars = np.empty((n_iter, n_pars), npd)
    times = np.empty((n_iter,), npd)
    for i in range(n_iter):
        over = gen(i) or {}
        states[i] = np.asarray(over.get("state", ta.state), npd)
        pars[i] = np.asarray(over.get("pars", ta.pars),
                             npd).reshape(n_pars)
        times[i] = float(over.get("time", ta.time))
    return states, pars, times


def _shards(ta, n_iter, mesh):
    """``[(device, slice)]``: the whole ensemble on the template's device,
    or equal contiguous shards over ``mesh``'s devices."""
    if mesh is None:
        return [(ta._tb._device, slice(0, n_iter))]
    devs = [resolve_device(d) for d in mesh]
    if not devs or n_iter % len(devs):
        raise ValueError(f"n_iter ({n_iter}) must be divisible by the mesh's "
                         f"{len(devs)} devices")
    m = n_iter // len(devs)
    return [(d, slice(i * m, (i + 1) * m)) for i, d in enumerate(devs)]


class _Hits:
    """The non-terminal hits of one event, kept by the batch's dispatch as
    a vectorized callback (one call with the arrays of its hits)."""

    vectorized = True

    def __init__(self):
        self.parts = []

    def __call__(self, tb, ts, sgn, lanes):
        self.parts.append((np.asarray(ts), np.asarray(sgn),
                           np.asarray(lanes)))


def _lane_events(ta):
    """The ensemble batch's events: the template's terminal ones with no
    callback (pure-stop) and its non-terminal ones with a recorder each."""
    tes = [t_event(ev.expression, cooldown=ev.cooldown,
                   direction=ev.direction) for ev in ta.t_events]
    recs = [_Hits() for _ in ta.nt_events]
    ntes = [nt_event(ev.expression, rec, direction=ev.direction)
            for ev, rec in zip(ta.nt_events, recs)]
    return tes, ntes, recs


def _run(ta, n_iter, states, pars, times, mesh, call):
    """``call(tb)`` on each shard's batch (its lanes the shard's
    instances); returns ``[(tb, call's result, hit recorders, offset)]``."""
    out = []
    for dev, sl in _shards(ta, n_iter, mesh):
        tes, ntes, recs = _lane_events(ta)
        tb = TaylorAdaptiveBatch._sharing(
            _engine(ta, dev), states[sl], pars=pars[sl], time=times[sl],
            t_events=tes, nt_events=ntes)
        out.append((tb, call(tb, sl), recs, sl.start))
    return out


def _gather(runs, with_out=False):
    """The shards' results as one dict of tensors on the first shard's
    device."""
    dev = runs[0][0]._device

    def cat(xs):
        return torch.cat([torch.as_tensor(x).to(dev) for x in xs])

    res = {
        "state": cat(tb._state for tb, *_ in runs),
        "time": cat(tb._t_hi + tb._t_lo for tb, *_ in runs),
        "outcome": cat(torch.as_tensor([int(o) for o in r[0]],
                                       dtype=torch.int32)
                       for _, r, *_ in runs),
        "min_h": cat(torch.as_tensor(r[1]) for _, r, *_ in runs),
        "max_h": cat(torch.as_tensor(r[2]) for _, r, *_ in runs),
        "nsteps": cat(torch.as_tensor(r[3], dtype=torch.int64)
                      for _, r, *_ in runs),
    }
    if with_out:
        res = {"out": cat(r[4] for _, r, *_ in runs), **res}
    return res


def _hits(ta, runs, res, fwd):
    """The terminal stops and the non-terminal hits of an event ensemble
    (``ensemble.py:421-458``): ``te_idx``, ``te_sgn``, the hits of each
    instance padded to the most any instance has (``nt_times`` NaN,
    ``nt_idx`` -1, ``nt_sgn`` 0; ``nt_count``), in time order; then the
    non-terminal callbacks ``cb(results, t, d_sgn, instance)``."""
    dev = res["state"].device
    oc = res["outcome"]
    res["te_idx"] = torch.where(oc >= 0, oc, torch.full_like(oc, -1))
    res["te_sgn"] = torch.cat([tb._last_te_sgn.to(dev) for tb, *_ in runs]) \
        .to(torch.int32) if ta.t_events else torch.zeros_like(oc)
    n_iter = oc.shape[0]
    parts = [(ts, np.full(ts.size, j), sg, ln + off)
             for _, _, recs, off in runs for j, rec in enumerate(recs)
             for ts, sg, ln in rec.parts]
    if parts:
        ts, idx, sg, ln = (np.concatenate(x) for x in zip(*parts))
    else:
        ts, idx, sg, ln = (np.zeros(0, t) for t in (float, int, int, int))
    order = np.lexsort((np.where(fwd[ln], ts, -ts), ln))
    ts, idx, sg, ln = (a[order] for a in (ts, idx, sg, ln))
    counts = np.bincount(ln, minlength=n_iter)
    cap = max(1, int(counts.max(initial=0)))
    slot = np.arange(ln.size) - np.repeat(np.cumsum(counts) - counts, counts)
    nt_times = np.full((n_iter, cap), np.nan)
    nt_idx = np.full((n_iter, cap), -1, np.int32)
    nt_sgn = np.zeros((n_iter, cap), np.int32)
    nt_times[ln, slot], nt_idx[ln, slot], nt_sgn[ln, slot] = ts, idx, sg
    res.update(nt_times=torch.as_tensor(nt_times, device=dev),
               nt_idx=torch.as_tensor(nt_idx, device=dev),
               nt_sgn=torch.as_tensor(nt_sgn, device=dev),
               nt_count=torch.as_tensor(counts, device=dev))
    evs = ta.nt_events
    if any(ev.callback is not None for ev in evs):
        for i, t, j, s in zip(ln.tolist(), ts.tolist(), idx.tolist(),
                              sg.tolist()):
            cb = evs[j].callback
            if cb is not None:
                cb(res, t, s, i)
    return res


def _te_callbacks(ta) -> bool:
    return any(ev.callback is not None for ev in ta.t_events)


def ensemble_propagate_until(ta, t, n_iter: int, gen, *, max_delta_t=None,
                             max_steps=0, mesh=None):
    """Propagate ``n_iter`` instances of ``ta`` (each given its state,
    parameters and time by ``gen``) until ``t`` (a scalar, or one target
    an instance); returns a dict of stacked tensors on the template's
    device: ``state``, ``time``, ``outcome``, ``min_h``, ``max_h``,
    ``nsteps``, and with events ``te_idx``, ``te_sgn``, ``nt_times``,
    ``nt_idx``, ``nt_sgn`` and ``nt_count``.  ``mesh``: a sequence of
    devices to shard the instances over."""
    states, pars, times = _build_inputs(ta, n_iter, gen)
    if max_delta_t is None:
        max_delta_t = _pymath.inf
    t_all = np.array(np.broadcast_to(np.asarray(t, ta._tb.dtype), (n_iter,)))
    if _te_callbacks(ta):
        return _host_fallback(ta, n_iter, states, pars, times, t_all,
                              max_delta_t, int(max_steps))

    def call(tb, sl):
        return tb.propagate_until(t_all[sl], max_delta_t=max_delta_t,
                                  max_steps=max_steps)

    runs = _run(ta, n_iter, states, pars, times, mesh, call)
    res = _gather(runs)
    if ta.t_events or ta.nt_events:
        res = _hits(ta, runs, res, t_all >= times)
    return res


def ensemble_propagate_for(ta, delta_t, n_iter: int, gen, **kw):
    """:func:`ensemble_propagate_until` to each instance's own start time
    plus ``delta_t``."""
    states, pars, times = _build_inputs(ta, n_iter, gen)
    return ensemble_propagate_until(
        ta, times + float(delta_t), n_iter,
        {"state": states, "pars": pars, "time": times}, **kw)


def ensemble_propagate_grid(ta, grid, n_iter: int, gen, *, max_delta_t=None,
                            max_steps=0, mesh=None):
    """The states of ``n_iter`` instances of ``ta`` at the points of the
    shared, monotonic time ``grid``: the dict of
    :func:`ensemble_propagate_until` (without the event fields) and ``out``
    (n_iter, len(grid), dim).  With events, the per-instance host
    fallback."""
    states, pars, times = _build_inputs(ta, n_iter, gen)
    if max_delta_t is None:
        max_delta_t = _pymath.inf
    if ta.t_events or ta.nt_events:
        return _host_fallback(ta, n_iter, states, pars, times, None,
                              max_delta_t, int(max_steps), grid=grid)

    def call(tb, sl):
        return tb._grid(grid, max_delta_t=max_delta_t, max_steps=max_steps)

    return _gather(_run(ta, n_iter, states, pars, times, mesh, call),
                   with_out=True)


def _host_fallback(ta, n_iter, states, pars, times, t, max_delta_t,
                   max_steps, grid=None):
    """Terminal events with callbacks (until) or any events (grid): one
    working copy of the template propagates each instance in turn, its
    event callbacks given the working copy as the template's are given
    the template (``ensemble.py:462-655``); a batch template's copy takes
    one instance's ``B`` lanes at a time.  Results on the template's
    device; ``te_idx`` for ``propagate_until``, ``out`` for the grid."""
    batch = isinstance(ta, _BatchTemplate)
    if batch:
        b = ta._tab.batch_size
        work = TaylorAdaptiveBatch._sharing(ta._tab, states[:b],
                                            pars=pars[:b], time=times[:b])
    else:
        b = 1
        work = TaylorAdaptive._copy_of(ta)
    dim = ta.dim
    out_state = np.empty((n_iter, dim))
    out_time = np.empty(n_iter)
    oc = np.full(n_iter, int(TaylorOutcome.time_limit), np.int32)
    min_h, max_h = np.full(n_iter, _pymath.inf), np.zeros(n_iter)
    nsteps = np.zeros(n_iter, np.int64)
    rows = None if grid is None else np.full(
        (n_iter, np.asarray(grid).shape[0], dim), np.nan)
    for i in range(n_iter // b):
        sl = slice(i * b, (i + 1) * b)
        if batch:
            work.state, work.pars = states[sl], pars[sl]
            work.set_time(times[sl])
        else:
            work.state, work.pars = states[i], pars[i]
            work.time = float(times[i])
        work.reset_cooldowns()
        kw = dict(max_delta_t=max_delta_t, max_steps=max_steps)
        if grid is None:
            r = work.propagate_until(t[sl] if batch else float(t[i]), **kw)
        else:
            r = work.propagate_grid(grid, **kw)
            rows[sl] = r[4]
        ocs = r[0] if batch else [r[0]]
        oc[sl] = [int(o) for o in ocs]
        min_h[sl], max_h[sl], nsteps[sl] = r[1], r[2], r[3]
        out_state[sl] = work.state
        out_time[sl] = work.time
    dev = ta._tb._device
    res = {k: torch.as_tensor(v, device=dev) for k, v in (
        ("state", out_state), ("time", out_time), ("outcome", oc),
        ("min_h", min_h), ("max_h", max_h), ("nsteps", nsteps))}
    if grid is None:
        res["te_idx"] = torch.where(res["outcome"] >= 0, res["outcome"],
                                    torch.full_like(res["outcome"], -1))
    else:
        res = {"out": torch.as_tensor(rows, device=dev), **res}
    return res


# -- batch variants -----------------------------------------------------------
# (reference ensemble_propagate_*_batch, ensemble_propagate.hpp:180-269):
# the (n_iter, B) instances flattened into n_iter * B lanes


def _flatten_batch_gen(tab, n_iter, gen):
    b = tab.batch_size
    if not isinstance(gen, dict):
        raise TypeError("batch ensembles take a dict of stacked arrays")
    states = np.asarray(gen["state"], dtype=tab.dtype)
    if states.shape[:2] != (n_iter, b):
        raise ValueError(f"state must have shape ({n_iter}, {b}, dim)")
    out = {"state": states.reshape(n_iter * b, -1)}
    if gen.get("pars") is not None:
        out["pars"] = np.asarray(gen["pars"], tab.dtype).reshape(
            n_iter * b, -1)
    if gen.get("time") is not None:
        out["time"] = np.broadcast_to(np.asarray(gen["time"], tab.dtype),
                                      (n_iter, b)).reshape(n_iter * b)
    return out


def _reshape_res(res, n_iter, b):
    return {k: v.reshape((n_iter, b) + tuple(v.shape[1:]))
            for k, v in res.items()}


def ensemble_propagate_until_batch(tab, t, n_iter: int, gen, **kw):
    """:func:`ensemble_propagate_until` over ``n_iter`` instances of the
    batch integrator ``tab`` (``gen`` a dict of (n_iter, B, ...) arrays);
    results (n_iter, B, ...)."""
    res = ensemble_propagate_until(
        _BatchTemplate(tab), t, n_iter * tab.batch_size,
        _flatten_batch_gen(tab, n_iter, gen), **kw)
    return _reshape_res(res, n_iter, tab.batch_size)


def ensemble_propagate_for_batch(tab, delta_t, n_iter: int, gen, **kw):
    res = ensemble_propagate_for(
        _BatchTemplate(tab), delta_t, n_iter * tab.batch_size,
        _flatten_batch_gen(tab, n_iter, gen), **kw)
    return _reshape_res(res, n_iter, tab.batch_size)


def ensemble_propagate_grid_batch(tab, grid, n_iter: int, gen, **kw):
    res = ensemble_propagate_grid(
        _BatchTemplate(tab), grid, n_iter * tab.batch_size,
        _flatten_batch_gen(tab, n_iter, gen), **kw)
    return _reshape_res(res, n_iter, tab.batch_size)
