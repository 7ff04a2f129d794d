"""The batch step with events: root isolation and refinement of the event
polynomials of a step, in torch on the tensors' device, in the
integrator's dtype (float64, or float32 as the JAX package isolates an f32
integrator's events: ``events_impl.py:576, 819-820`` there).

The counterpart of ``heyoka_tpu/taylor/events_impl.py`` (reference: heyoka
``ed_data_batch::detect_events``, ``src/detail/event_detection.cpp:
1733``): the event equations are sv-func rows of the jet (the route's
kernel, B2, B3 or B4, returns them after the state rows) and take part in
the step-size norms; their Taylor polynomials over the step, in s = tau /
h on [0, 1), are isolated and refined, the step is truncated at the
earliest allowed terminal root, and the non-terminal roots before it are
reported.

- :func:`_make_tree_isolator`: the static subdivision tree of depth
  ``TREE_DEPTH``: the Descartes transform of every node is a constant
  linear map of a row's coefficients, so one ``torch.matmul`` by a
  ``(p+1, n_nodes (p+1))`` matrix built once in numpy gives them all,
  then sign-variation counts;
- :func:`_make_isolator`: the Collins-Akritas working list (capacity
  ``CA_QUEUE``, ``CA_MAXIT`` iterations), batched over the rows the tree
  cannot certify, a torch loop with a host-checked exit;
- :func:`_refine_roots`: ``BISECT_ITERS`` bisections, then
  ``NEWTON_ITERS`` guarded Newton steps, duplicate merging and the
  crossing direction.

The JAX package computes all of this outside its Pallas kernels (XLA on
the TPU, in the integrator's dtype), so it is torch here, not a kernel.  What the JAX module adds
for the TPU is left out: the certified-f32 tree (f64 is emulated there;
its roots equal the f64 path's by construction), the ``top_k`` row
budgets with their dense fallbacks and the debug knobs.  Rows that pass
the fast exclusion test (no root possible) are dropped before the tree
(``nonzero``), which gives the roots of the dense f64 path.
"""

from __future__ import annotations

import math as _pymath

import numpy as np
import torch

from ..dfloat import dd_add_d
from ..logging import host_read, trace_ctx
from .jet_kernels import JetTape, jet as _jet_b2
from .outcome import TaylorOutcome
from .stepper import ceval_update, h_from_norms, horner_update

#: max roots tracked per event equation per step
MAX_ROOTS = 4
#: bisection iterations before Newton polishing (2^-26 interval width)
BISECT_ITERS = 26
#: guarded Newton polish iterations
NEWTON_ITERS = 3
#: subdivision depth of the tree isolator (intervals of width 2^-D)
TREE_DEPTH = 5
#: working-list capacity and iteration budget of the Collins-Akritas
#: isolator
CA_QUEUE = 16
CA_MAXIT = 100

_F64 = torch.float64


def _eps(dtype) -> float:
    """The machine epsilon of torch ``dtype``."""
    return float(torch.finfo(dtype).eps)


def _poly_eval(coeffs, x):
    """Horner evaluation: ``coeffs (..., p+1)`` ascending, ``x``
    broadcastable to ``coeffs[..., 0]``."""
    p = coeffs.shape[-1] - 1
    res = coeffs[..., p]
    for k in range(p - 1, -1, -1):
        res = res * x + coeffs[..., k]
    return res


def _poly_deriv_eval(coeffs, x):
    p = coeffs.shape[-1] - 1
    res = coeffs[..., p] * float(p)
    for k in range(p - 1, 0, -1):
        res = res * x + coeffs[..., k] * float(k)
    return res


def _comb(p):
    comb = np.zeros((p + 1, p + 1))
    for j in range(p + 1):
        for i in range(j + 1):
            comb[i, j] = _pymath.comb(j, i)
    return comb


def _sign_variations(s):
    """Sign variations along the last axis of the signs ``s`` (zeros
    skipped), as int32."""
    prev = torch.zeros_like(s[..., 0])
    cnt = torch.zeros(s.shape[:-1], dtype=torch.int32, device=s.device)
    for k in range(s.shape[-1]):
        sk = s[..., k]
        cnt += ((prev * sk) < 0).to(torch.int32)
        prev = torch.where(sk == 0, prev, sk)
    return cnt


def _powvec(x, p):
    """``[1, x, ..., x^p]`` along a new last axis, by a running product
    (the JAX package's ``cumprod``)."""
    return torch.cat([torch.ones_like(x)[..., None],
                      torch.cumprod(x[..., None].expand(*x.shape, p), -1)],
                     -1)


def _make_isolator(p, max_roots, device, dtype=_F64):
    """``isolate(cs (R, p+1)) -> (rlo, rhi, valid)``, each ``(R,
    max_roots)``: Collins-Akritas with a bounded working list on [0, 1]
    for every row at once (the JAX ``_make_isolator`` :81, vmapped).  A
    row iterates while its list holds an interval, it has fewer than
    ``max_roots`` roots and its budget lasts; the loop ends when no row
    does (one host check an iteration).  Tables and intervals in
    ``dtype``, the rows' dtype."""
    comb = torch.as_tensor(_comb(p), dtype=dtype, device=device)
    idx = np.arange(p + 1)
    expi = torch.as_tensor(np.clip(idx[None, :] - idx[:, None], 0, p),
                           device=device)
    tiny = 16.0 * _eps(dtype)
    slots = torch.arange(max_roots, device=device)

    def shift_scale(c, a, w):
        # q(x) = c(a + w x): Taylor shift by a, then scale by w
        M = comb * _powvec(a, p)[:, expi]
        return torch.matmul(M, c[:, :, None])[:, :, 0] * _powvec(w, p)

    def descartes(q):
        v = torch.matmul(q.flip(-1), comb.T)
        return _sign_variations(torch.sign(v))

    def isolate(c):
        R = c.shape[0]
        dev = c.device
        rows = torch.arange(R, device=dev)
        # a root exactly at s = 0: record it and deflate by one power of s
        root0 = c[:, 0] == 0.0
        c = torch.where(root0[:, None],
                        torch.cat([c[:, 1:], torch.zeros_like(c[:, :1])], 1),
                        c)
        qlo = torch.zeros((R, CA_QUEUE), dtype=dtype, device=dev)
        qhi = qlo.clone()
        qhi[:, 0] = 1.0
        qact = torch.zeros((R, CA_QUEUE), dtype=torch.bool, device=dev)
        qact[:, 0] = True
        rlo = torch.full((R, max_roots), 2.0, dtype=dtype, device=dev)
        rlo[:, 0] = torch.where(root0, 0.0, 2.0)
        rhi = rlo.clone()
        rn = root0.to(torch.int64)
        it = 0
        while True:
            run = qact.any(1) & (rn < max_roots)
            if it >= CA_MAXIT or not bool(run.any()):
                break
            i = qact.to(torch.int8).argmax(1)
            a, b = qlo[rows, i], qhi[rows, i]
            qact = qact.clone()
            qact[rows, i] = torch.where(run, False, qact[rows, i])
            w = b - a
            V = descartes(shift_scale(c, a, w))
            emit = run & ((V == 1) | ((V >= 2) & (w < tiny)))
            slot = rn.clamp(max=max_roots - 1)
            at = emit[:, None] & (slots[None, :] == slot[:, None])
            rlo = torch.where(at, a[:, None], rlo)
            rhi = torch.where(at, b[:, None], rhi)
            rn = rn + emit.to(torch.int64)
            split = run & (V >= 2) & (w >= tiny)
            m = a + 0.5 * w
            # a split point that is itself a root moves off-centre
            m = torch.where(_poly_eval(c, m) == 0.0, a + 0.46193376 * w, m)
            for lo_, hi_ in ((a, m), (m, b)):
                f = qact.to(torch.int8).argmin(1)
                can = split & ~qact[rows, f]
                put = can[:, None] & (torch.arange(CA_QUEUE, device=dev)
                                      [None, :] == f[:, None])
                qlo = torch.where(put, lo_[:, None], qlo)
                qhi = torch.where(put, hi_[:, None], qhi)
                qact = qact | put
            it += 1
        isolate.iterations += it
        return rlo, rhi, slots[None, :] < rn[:, None]

    isolate.iterations = 0  # the list's iterations over every call
    return isolate


def _tree_tables(p, depth):
    """The node table, the ancestor mask and the ``(p+1, n_nodes (p+1))``
    transform of the subdivision tree, in numpy (JAX
    ``_make_tree_isolator`` :188)."""
    nodes = [(i / (1 << d), 1.0 / (1 << d), d)
             for d in range(depth + 1) for i in range(1 << d)]
    n_nodes = len(nodes)
    anc = np.zeros((n_nodes, n_nodes), bool)
    for d in range(depth + 1):
        for i in range(1 << d):
            n = (1 << d) - 1 + i
            dd, ii = d, i
            while dd > 0:
                dd -= 1
                ii //= 2
                anc[(1 << dd) - 1 + ii, n] = True
    comb = _comb(p)
    T = np.zeros((n_nodes, p + 1, p + 1))
    for n, (a, w, _) in enumerate(nodes):
        M = np.zeros((p + 1, p + 1))
        for j in range(p + 1):
            for i in range(j + 1):
                M[i, j] = comb[i, j] * a ** (j - i)
        M = (w ** np.arange(p + 1))[:, None] * M
        T[n] = comb @ M[::-1, :]
    return nodes, anc, T.transpose(2, 0, 1).reshape(p + 1, n_nodes * (p + 1))


def _make_tree_isolator(p, max_roots, device, depth=TREE_DEPTH, dtype=_F64):
    """``isolate_tree(cs (R, p+1)) -> (rlo, rhi, valid, fallback)``: the
    whole binary subdivision tree of depth ``depth`` over [0, 1] at once,
    one matrix product for every node's Descartes transform.  A node with
    one sign variation, a sign change over it and no such ancestor
    isolates one root; exact zeros at the grid points are roots of width
    0; a row the tree cannot certify (a one-variation node without a sign
    change, two or more variations at a leaf) sets ``fallback``, and the
    caller runs it through :func:`_make_isolator`.  The tables are built
    in f64 numpy and rounded once to ``dtype``, the rows' dtype."""
    nodes, anc, tm = _tree_tables(p, depth)
    n_nodes = len(nodes)
    TM = torch.as_tensor(tm, dtype=dtype, device=device)
    ngrid = (1 << depth) + 1
    grid = np.arange(ngrid) / float(1 << depth)
    VG = torch.as_tensor(grid[None, :] ** np.arange(p + 1)[:, None],
                         dtype=dtype, device=device)
    node_a = np.array([a for a, _, _ in nodes])
    node_b = np.array([a + w for a, w, _ in nodes])
    gi_a = torch.as_tensor(np.rint(node_a * (1 << depth)).astype(np.int64),
                           device=device)
    gi_b = torch.as_tensor(np.rint(node_b * (1 << depth)).astype(np.int64),
                           device=device)
    ANC = torch.as_tensor(anc, dtype=dtype, device=device)
    LEAF = torch.as_tensor(np.array([d == depth for _, _, d in nodes]),
                           device=device)
    cand_a = torch.as_tensor(np.concatenate([node_a, grid]), dtype=dtype,
                             device=device)
    cand_b = torch.as_tensor(np.concatenate([node_b, grid]), dtype=dtype,
                             device=device)

    def isolate_tree(cs):
        R = cs.shape[0]
        q = torch.matmul(cs, TM).reshape(R, n_nodes, p + 1)
        V = _sign_variations(torch.sign(q))
        gv = torch.matmul(cs, VG)
        sign_change = gv[:, gi_a] * gv[:, gi_b] < 0.0
        v1 = V == 1
        anc_v1 = torch.matmul(v1.to(dtype), ANC) > 0
        emit = v1 & sign_change & ~anc_v1
        bad_v1 = v1 & ~anc_v1 & ~sign_change
        bad_leaf = (V >= 2) & LEAF[None, :] & ~anc_v1
        fallback = (bad_v1 | bad_leaf).any(1)
        # the isolating nodes and the exact zeros at the grid points, the
        # earliest max_roots of them (a stable sort: the JAX top_k's order)
        cand = torch.cat([emit, gv == 0.0], 1)
        key = torch.where(cand, cand_a[None, :], 2.0)
        rlo, order = torch.sort(key, dim=1, stable=True)
        rlo, order = rlo[:, :max_roots], order[:, :max_roots]
        valid = rlo <= 1.0
        rhi = torch.where(valid, cand_b[order], 2.0)
        return torch.where(valid, rlo, 2.0), rhi, valid, fallback

    return isolate_tree


def _refine_roots(cs, rlo, rhi, valid):
    """Bisection and Newton refinement, duplicate merging and the crossing
    direction in s, on the isolating intervals ``rlo``/``rhi`` ``(R,
    MAX_ROOTS)`` of the rows ``cs (R, p+1)`` (JAX :475), in their dtype.
    Returns ``(s_root, valid, d_sgn_s)``."""
    c3 = cs[:, None, :]
    g_lo = _poly_eval(c3, rlo)
    g_hi = _poly_eval(c3, rhi)
    has_sc = g_lo * g_hi < 0.0
    lo_f, hi_f, glo = rlo, rhi, g_lo
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo_f + hi_f)
        gm = _poly_eval(c3, mid)
        left = glo * gm > 0.0
        lo_f = torch.where(left, mid, lo_f)
        hi_f = torch.where(left, hi_f, mid)
        glo = torch.where(left, gm, glo)
    s_root = torch.where(has_sc, 0.5 * (lo_f + hi_f), 0.5 * (rlo + rhi))
    for _ in range(NEWTON_ITERS):
        g = _poly_eval(c3, s_root)
        gder = _poly_deriv_eval(c3, s_root)
        cand = s_root - g / gder
        ok = torch.isfinite(cand) & (cand >= lo_f) & (cand <= hi_f)
        s_root = torch.where(has_sc & ok, cand, s_root)
    # half-open [0, h)
    valid = valid & (s_root < 1.0)
    # merge roots closer than 16 sqrt(eps) in s
    merge_eps = 16.0 * _pymath.sqrt(_eps(cs.dtype))
    cols = [valid[:, 0]]
    for i in range(1, valid.shape[1]):
        dup = torch.zeros_like(cols[0])
        for j in range(i):
            dup = dup | (cols[j] & ((s_root[:, i] - s_root[:, j]).abs()
                                    < merge_eps))
        cols.append(valid[:, i] & ~dup)
    valid = torch.stack(cols, 1)
    gd = _poly_deriv_eval(c3, s_root)
    d_sgn_s = torch.where(g_hi != 0.0, torch.sign(g_hi),
                          torch.where(g_lo != 0.0, -torch.sign(g_lo),
                                      torch.sign(gd)))
    return s_root, valid, d_sgn_s


def make_find_roots(order, device, dtype=_F64):
    """``find_roots(gcoeffs (B, ne, K+1), h (B,)) -> (s_roots, valid,
    d_sgn)``, each ``(B, ne, MAX_ROOTS)``: the roots in s of each event
    polynomial of each lane over [0, 1), their validity and the crossing
    direction in time.  The rows that pass the fast exclusion test
    (``|c_0| > sum |c_k|``: no root on [0, 1]) are dropped, the tree
    isolates the rest, the Collins-Akritas list takes the rows the tree
    cannot certify, and the roots are refined.  ``find_roots.stats``
    counts, over every call, the calls, the rows, the rows the tree took,
    the rows it could not certify and the Collins-Akritas iterations (host
    integers the two ``nonzero`` syncs give anyway; each a
    ``hy.sync.roots`` span).  Every table and result in ``dtype``, the
    rows' dtype."""
    tree = _make_tree_isolator(order, MAX_ROOTS, device, dtype=dtype)
    ca = _make_isolator(order, MAX_ROOTS, device, dtype=dtype)
    stats = dict(calls=0, rows=0, tree_rows=0, fallback_rows=0, ca_iters=0)

    def find_roots(gcoeffs, h):
        B, ne, p1 = gcoeffs.shape
        dev = gcoeffs.device
        hp = _powvec(h, order)
        cs = (gcoeffs * hp[:, None, :]).reshape(B * ne, p1)
        need = cs[:, 0].abs() <= cs[:, 1:].abs().sum(1)
        s_root = torch.full((B * ne, MAX_ROOTS), 2.0, dtype=dtype,
                            device=dev)
        valid = torch.zeros((B * ne, MAX_ROOTS), dtype=torch.bool,
                            device=dev)
        d_sgn_s = torch.zeros((B * ne, MAX_ROOTS), dtype=dtype, device=dev)
        idx = host_read("hy.sync.roots", need.nonzero)[:, 0]
        stats["calls"] += 1
        stats["rows"] += B * ne
        stats["tree_rows"] += idx.numel()
        if idx.numel():
            sub = cs.index_select(0, idx)
            rlo, rhi, val, fb = tree(sub)
            fbi = host_read("hy.sync.roots", fb.nonzero)[:, 0]
            if fbi.numel():
                n0 = ca.iterations
                clo, chi, cval = ca(sub.index_select(0, fbi))
                rlo[fbi], rhi[fbi], val[fbi] = clo, chi, cval
                stats["fallback_rows"] += fbi.numel()
                stats["ca_iters"] += ca.iterations - n0
            s, v, d = _refine_roots(sub, rlo, rhi, val)
            s_root[idx], valid[idx], d_sgn_s[idx] = s, v, d
        shape = (B, ne, MAX_ROOTS)
        d_sgn = torch.where(h[:, None, None] >= 0, d_sgn_s.reshape(shape),
                            -d_sgn_s.reshape(shape)).to(torch.int32)
        return s_root.reshape(shape), valid.reshape(shape), d_sgn

    find_roots.stats = stats
    return find_roots


def build_event_step_batch(tape: JetTape, t_events, nt_events, tol, *,
                           high_accuracy: bool = True, jet=_jet_b2,
                           dtype=_F64):
    """The whole-batch step with events over the route's ``jet`` (the
    contract of ``jet_kernels.jet``; ``tape`` decomposed with the event
    equations as its sv-funcs, terminal events first): ``ev_step_b(state
    (B, n), pars (B, p), t_hi, t_lo, max_dt, cooldowns (B, n_te)) ->
    dict`` with the fields of the JAX ``ev_step_b`` (``events_impl.py:
    1063-1200``): ``state``, ``t_hi``, ``t_lo``, ``last_h`` (the step,
    truncated at a terminal root), ``tc (B, K+1, n_eq + n_ev)`` (the
    event columns kept), ``outcome`` (the terminal event's index where one
    stopped the step), ``cooldowns``, ``te_idx`` (-1: none), ``te_time``,
    ``te_sgn`` and the non-terminal hits per slot, ``n_nte * MAX_ROOTS``
    a lane: ``nt_mask``, ``nt_times``, ``nt_idx``, ``nt_sgn``.

    Attributes: ``plain_step_b(state, pars, t_hi, t_lo, max_dt)``, the
    step without isolation, with the raw event rows ``ev_row (B, n_ev,
    K+1)``; ``jet_b(state, pars, t_hi, max_dt) -> (tc, h)``, the jet and
    the step size; ``find_roots_b`` (:func:`make_find_roots`).  The event
    step calls the last two through these attributes.  Spans
    (:mod:`..logging`): ``hy.events.step`` a step, ``hy.events.isolate``
    its ``find_roots_b``.

    ``dtype``: the lanes' dtype, in which the roots are isolated and
    refined, the cooldowns kept and the ``eps`` of ``g_eps`` taken, as
    the JAX package's event step does in its integrator's dtype."""
    n_te, n_nte = len(t_events), len(nt_events)
    n_eq, K = tape.n_eq, tape.order
    dev = tape.device
    tol_val = float(tol)
    assert tape.n_out == n_te + n_nte, "the tape's sv-funcs are the events"

    def ints(evs):
        return torch.as_tensor([int(e.direction) for e in evs],
                               dtype=torch.int32, device=dev)

    te_dirs, nt_dirs = ints(t_events), ints(nt_events)
    te_cd_user = torch.as_tensor(
        [_pymath.nan if e.cooldown is None else float(e.cooldown)
         for e in t_events], dtype=dtype, device=dev)
    nt_idx_row = torch.arange(n_nte, dtype=torch.int32,
                              device=dev).repeat_interleave(MAX_ROOTS)
    update = ceval_update if high_accuracy else horner_update
    find_roots = make_find_roots(K, dev, dtype)
    eps = _eps(dtype)

    def jet_b(state, pars, t_hi, max_dt):
        tcs, norms = jet(tape, state.T.contiguous(), pars.T.contiguous(),
                         t_hi.contiguous())
        h = h_from_norms(norms[2], norms[0], norms[1], K, max_dt)
        return tcs.permute(2, 1, 0), h  # (B, K+1, n_eq + n_ev)

    def advance(tc, t_hi, t_lo, h):
        new = update(tc.permute(1, 2, 0), h, K, n_eq).T
        nt_hi, nt_lo = dd_add_d(t_hi, t_lo, h)
        finite = torch.isfinite(new).all(1) & torch.isfinite(h)
        return new, nt_hi, nt_lo, finite

    def ev_step_b(state, pars, t_hi, t_lo, max_dt, cooldowns):
        with trace_ctx("hy.events.step"):
            return event_step(state, pars, t_hi, t_lo, max_dt, cooldowns)

    def event_step(state, pars, t_hi, t_lo, max_dt, cooldowns):
        B = state.shape[0]
        # the parts through the attributes, which a timer may wrap
        tc, h = ev_step_b.jet_b(state, pars, t_hi, max_dt)
        # g_eps of the auto cooldown (taylor_adaptive.cpp:812-840)
        max_abs = tc[:, 0, :].abs().amax(1)
        max_r = torch.where(max_abs < 1.0, tol_val, tol_val * max_abs)
        g_eps = torch.maximum(max_r, eps * max_abs)

        ev_coeffs = tc[:, :, n_eq:].transpose(1, 2)  # (B, n_ev, K+1)
        with trace_ctx("hy.events.isolate"):
            s_roots, valid, d_sgn = ev_step_b.find_roots_b(ev_coeffs, h)
        tau = s_roots * h[:, None, None]
        lanes = torch.arange(B, device=state.device)

        if n_te:
            te_s, te_sgn = s_roots[:, :n_te], d_sgn[:, :n_te]
            dir_ok = (te_dirs[None, :, None] == 0) | (
                te_sgn == te_dirs[None, :, None])
            cd_ok = tau[:, :n_te].abs() >= cooldowns[:, :, None]
            ok = valid[:, :n_te] & dir_ok & cd_ok
            s_masked = torch.where(ok, te_s, 2.0)
            per_ev = s_masked.amin(2)  # (B, n_te)
            te_s_star, te_best = per_ev.min(1)
            te_found = te_s_star <= 1.0
            slot = s_masked[lanes, te_best].argmin(1)
            te_d = te_sgn[lanes, te_best, slot]
        else:
            te_found = torch.zeros(B, dtype=torch.bool, device=state.device)
            te_s_star = torch.full((B,), 2.0, dtype=dtype,
                                   device=state.device)
            te_best = torch.zeros(B, dtype=torch.int64, device=state.device)
            te_d = torch.zeros(B, dtype=torch.int32, device=state.device)

        h_eff = torch.where(te_found, te_s_star * h, h)
        new, nt_hi, nt_lo, finite = advance(tc, t_hi, t_lo, h_eff)

        if n_nte:
            nsgn = d_sgn[:, n_te:]
            dir_ok = (nt_dirs[None, :, None] == 0) | (
                nsgn == nt_dirs[None, :, None])
            before = torch.where(te_found[:, None, None],
                                 s_roots[:, n_te:] < te_s_star[:, None, None],
                                 True)
            nt_mask = (valid[:, n_te:] & dir_ok & before).reshape(B, -1)
            nt_times = (t_hi[:, None, None] + tau[:, n_te:]).reshape(B, -1)
            nt_sgn = nsgn.reshape(B, -1)
        else:
            nt_mask = torch.zeros((B, 0), dtype=torch.bool,
                                  device=state.device)
            nt_times = torch.zeros((B, 0), dtype=dtype, device=state.device)
            nt_sgn = torch.zeros((B, 0), dtype=torch.int32,
                                 device=state.device)

        if n_te:
            new_cd = (cooldowns - h_eff.abs()[:, None]).clamp(min=0.0)
            gd = _poly_deriv_eval(ev_coeffs[lanes, te_best], te_s_star * h)
            auto_cd = g_eps / gd.abs() * 10.0
            auto_cd = torch.where(torch.isfinite(auto_cd), auto_cd, 0.0)
            user = te_cd_user[te_best]
            trig_cd = torch.where(torch.isnan(user), auto_cd, user)
            hit = te_found[:, None] & (
                torch.arange(n_te, device=state.device)[None, :]
                == te_best[:, None])
            new_cd = torch.where(hit, trig_cd[:, None], new_cd)
        else:
            new_cd = cooldowns

        clamped = h.abs() >= max_dt.abs()
        outcome = torch.where(
            ~finite, int(TaylorOutcome.err_nf_state),
            torch.where(te_found, te_best.to(torch.int32),
                        torch.where(clamped, int(TaylorOutcome.time_limit),
                                    int(TaylorOutcome.success)))
        ).to(torch.int32)
        return dict(
            state=new, t_hi=nt_hi, t_lo=nt_lo, last_h=h_eff, tc=tc,
            outcome=outcome, cooldowns=new_cd,
            te_idx=torch.where(te_found, te_best.to(torch.int32), -1).to(
                torch.int32),
            te_time=t_hi + te_s_star * h, te_sgn=te_d.to(torch.int32),
            nt_mask=nt_mask, nt_times=nt_times,
            nt_idx=nt_idx_row[None, :].expand(B, -1), nt_sgn=nt_sgn,
        )

    def plain_step_b(state, pars, t_hi, t_lo, max_dt):
        """The event step without isolation: jet, h and the update, and
        the raw event rows ``ev_row (B, n_ev, K+1)``."""
        tc, h = jet_b(state, pars, t_hi, max_dt)
        new, nt_hi, nt_lo, finite = advance(tc, t_hi, t_lo, h)
        clamped = h.abs() >= max_dt.abs()
        outcome = torch.where(
            ~finite, int(TaylorOutcome.err_nf_state),
            torch.where(clamped, int(TaylorOutcome.time_limit),
                        int(TaylorOutcome.success))).to(torch.int32)
        return dict(state=new, t_hi=nt_hi, t_lo=nt_lo, last_h=h, tc=tc,
                    outcome=outcome,
                    ev_row=tc[:, :, n_eq:].transpose(1, 2))

    ev_step_b.plain_step_b = plain_step_b
    ev_step_b.jet_b = jet_b
    ev_step_b.find_roots_b = find_roots
    return ev_step_b
