"""Kernel T2: the f32 phase prototype, Taylor orders ``lo..K`` of a tape
of sum, mul and pow in f32, on the outer-Solar-System tape.

The counterpart of ``tools/proto_pallas_phase.py``, the first prototype of
the in-kernel f32 phase that became kernel B4 (``make_phase_kernel``):

- :func:`phase_body_plain`: a torch f32 copy of ``build_phase_body``
  (:23-84) for the rule set {sum, mul, pow}, with its value semantics;
- :func:`realistic_buffer`: the buffer of the prototype's ``main()``
  (:114-137): the north-star lanes in f32, order 0 on the host, orders
  1..lo-1 from the plain body;
- :func:`phase_f32`: the wrapper.  A CPU tensor runs the plain body; a
  CUDA tensor launches ``hy_proto_phase_f32`` (``csrc/proto_phase.cu``),
  which replaces the prototype's ``phase`` kernel (the ``kernel`` closure
  :173-237, ``pallas_call`` :240), or raises.  It takes kernel B4's
  ``(K+1, W, B)`` buffer, so that T2 and B4 run on one layout;
- :func:`run`: the prototype's ``main`` on the card (W = 381, order 19,
  B = 10,240, lo = 9), with kernel B4 (``jet_phase.phase``) in f64 from
  ``lo = 9`` on the same buffer beside it: the times of both and the
  per-order difference of f32 against f64, the measurement ROADMAP's
  precision ground rule asks for; :func:`sweep`: T2 at every block shape
  on the same buffer.

The other public functions keep the prototype's ``(W, K+1, B)`` f32
layout, lane index minor; :func:`run` permutes between the two outside
its timed windows.

``python -m heyoka_tpu_torch.tools.proto_phase`` runs :func:`run` on the
card and prints its result as one JSON line; it fails without a card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..convert import plan_from_arrays, plan_to_arrays
from ..expr.decompose import taylor_decompose_sys
from ..models import nbody
from ..taylor import jet_phase as jp
from ..taylor.compact import build_plan
from ..taylor.jet_kernels import _device_of
from . import GCONST, IC, MASSES, cuda_device, cuda_ms, graph_ms, smi_line
from .roofline import bound, nbytes, phase_bytes, phase_flops

ORDER = 19
LO = 9
B = 10_240
#: the prototype's rule set (the n-body tape's)
RULES = ("sum", "mul", "pow")
#: lanes a block of T2 that :func:`run` forces (``jet_phase.sweep_shapes``)
SWEEP_LANES = (1, 2, 3, 7, 16, 32)
#: kernel vs plain body, per order, relative to the order's largest
#: magnitude: f32 in both over sums of up to 20 terms; the kernel repeats
#: the body's order without FMA, so they should agree far closer
RTOL = 1e-5

_F32 = torch.float32


# ---------------------------------------------------------------------------
# plain body
# ---------------------------------------------------------------------------

def _selector(cols, dev):
    """Rows ``cols`` of a ``(W, ...)`` tensor: a slice where they are
    contiguous (the prototype's ``_contig``), else an index tensor."""
    cols = np.asarray(cols, np.int64)
    a = int(cols[0])
    if np.array_equal(cols, np.arange(a, a + cols.size)):
        return slice(a, a + cols.size)
    return torch.as_tensor(cols, device=dev)


def _rows(x, sel):
    return x[sel] if isinstance(sel, slice) else x.index_select(0, sel)


def phase_body_plain(plan, lo: int, K: int, n_eq: int):
    """``body(tc) -> tc``: orders ``lo..K`` of a ``(W, K'+1, B)`` buffer
    (K <= K'), with value semantics (the input is not written), in the
    prototype's order: per order k the state rows ``tc[rhs_cols, k-1] /
    k``, then the groups in level order; a sum adds its operands in turn, a
    mul is ``a_0 c_k + a_1 c_{k-1} + ...``, a pow is ``(a_0 b_k w_0 + a_1
    b_{k-1} w_1 + ...) / (k b_0)`` with ``w_j = f32(alpha (k-j) - j)``.
    Raises NotImplementedError for an op outside {sum, mul, pow}, as the
    prototype does; unlike it, a pow group may mix exponents."""
    groups = [g for lv in plan.levels for g in lv]
    for g in groups:
        if g.name not in RULES:
            raise NotImplementedError(g.name)
    tables = {}  # device -> (state-row selector, per-group tables)

    def prepare(dev):
        gs = []
        for g in groups:
            ins = [_selector(g.in_cols[:, q], dev)
                   for q in range(g.in_cols.shape[1])]
            w = None
            if g.name == "pow":  # w[k, j] = f32(alpha (k-j) - j), (m, 1)
                kk = np.arange(K + 1)[:, None, None]
                jj = np.arange(K + 1)[None, :, None]
                al = np.asarray(g.alpha, np.float64)[None, None, :]
                w = torch.as_tensor(
                    (al * (kk - jj) - jj).astype(np.float32)[..., None],
                    device=dev)
            gs.append((g.name, int(g.out_start), int(g.out_cols.size), ins,
                       w))
        return _selector(plan.rhs_cols, dev), gs

    def body(tc):
        dev = tc.device
        if dev not in tables:
            tables[dev] = prepare(dev)
        rhs, gs = tables[dev]
        tc = tc.clone()
        for k in range(lo, K + 1):
            # a tensor divisor: torch on CUDA multiplies by the reciprocal
            # of a Python scalar, which rounds otherwise
            kf = torch.full((), k, dtype=tc.dtype, device=dev)
            tc[:n_eq, k] = _rows(tc[:, k - 1], rhs) / kf
            for name, s, m, ins, w in gs:
                if name == "sum":
                    row = tc[:, k]
                    vals = _rows(row, ins[0])
                    for sel in ins[1:]:
                        vals = vals + _rows(row, sel)
                elif name == "mul":
                    A, C = _rows(tc, ins[0]), _rows(tc, ins[1])
                    vals = A[:, 0] * C[:, k]
                    for j in range(1, k + 1):
                        vals = vals + A[:, j] * C[:, k - j]
                else:
                    A, Bh = tc[s:s + m], _rows(tc, ins[0])
                    vals = A[:, 0] * Bh[:, k] * w[k, 0]
                    for j in range(1, k):
                        vals = vals + A[:, j] * Bh[:, k - j] * w[k, j]
                    vals = vals / (kf * Bh[:, 0])
                tc[s:s + m, k] = vals
        return tc

    return body


def realistic_buffer(plan, ic, n_lanes: int, lo: int, device, seed: int = 0):
    """The prototype's buffer (``main()`` :114-137) as a ``(W, K+1,
    n_lanes)`` f32 tensor on ``device``: ``n_lanes`` copies of ``ic``, each
    coordinate perturbed by a relative 1e-8 (``default_rng(seed)``) and
    rounded to f32; the constants; order 0 of every group in numpy as the
    prototype computes it; orders ``1..lo-1`` from
    :func:`phase_body_plain`."""
    W, n_eq, K = plan.width, plan.n_eq, plan.order
    rng = np.random.default_rng(seed)
    ic = np.asarray(ic, np.float64)
    states = (ic[None, :] + np.abs(ic)[None, :]
              * (rng.uniform(-1, 1, (n_lanes, ic.size)) * 1e-8)
              ).astype(np.float32)
    tc0 = np.zeros((W, K + 1, n_lanes), np.float32)
    tc0[:n_eq, 0, :] = states.T
    for ci, cv in plan.const_cols:
        tc0[ci, 0, :] = cv
    row0 = tc0[:, 0, :]
    for lv in plan.levels:
        for g in lv:
            if g.name == "sum":
                vals = row0[g.in_cols].sum(axis=1)
            elif g.name == "mul":
                vals = row0[g.in_cols[:, 0]] * row0[g.in_cols[:, 1]]
            elif g.name == "pow":
                vals = row0[g.in_cols[:, 0]] ** g.alpha[:, None]
            else:
                raise NotImplementedError(g.name)
            row0[g.out_start:g.out_start + g.out_cols.size] = vals
    tc = torch.as_tensor(tc0, device=device)
    return phase_body_plain(plan, 1, lo - 1, n_eq)(tc)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

class ProtoTape(jp.PhaseTape):
    """A plan's tables for kernel T2: kernel B4's (``PhaseTape``'s packed
    ``itab`` and ``dtab``, with the level table; the header of
    ``csrc/taylor_common.cuh``), restricted to :data:`RULES` (else
    ``UnsupportedKernelOp``), and the plan itself for the plain body."""

    RULES = RULES

    def __init__(self, arrays: dict, device):
        super().__init__(arrays, device)
        self.plan = plan_from_arrays(arrays)


def phase_f32(tables: ProtoTape, tc, lo: int):
    """Orders ``lo..K`` of the f32 buffer ``tc``, ``(K+1, W, B)`` as kernel
    B4's, in place; returns ``tc``.  A CPU tensor runs
    :func:`phase_body_plain` (on the prototype's view, ``tc.permute(1, 0,
    2)``); a CUDA tensor launches kernel T2 (``hy_proto_phase_f32``) at
    the block shape of ``jet_phase.block_shape``."""
    dev = _device_of(tc, tables)
    if dev.type == "cpu":
        K = tables.order
        jp._check_lo(lo, K)
        body = phase_body_plain(tables.plan, lo, K, tables.n_eq)
        return tc.copy_(body(tc.permute(1, 0, 2)).permute(1, 0, 2))
    return _phase_f32_cuda(tables, tc, lo)


def _phase_f32_cuda(tables: ProtoTape, tc, lo: int, lanes=None,
                    threads=None, layout=None):
    """Kernel T2 at a block shape of ``lanes`` x ``threads`` on ``layout``
    (default: ``jet_phase.block_shape``'s)."""
    return jp.launch("hy_proto_phase_f32", "proto_phase", tables, tc, lo,
                     _F32, lanes, threads, layout)


# ---------------------------------------------------------------------------
# the tool
# ---------------------------------------------------------------------------

def per_order_rel(a, b):
    """``(n, K+1, B)`` buffers: max |a - b| per order over rows and lanes,
    relative to the order's max |b| (f64)."""
    a, b = a.double(), b.double()
    scale = b.abs().amax(dim=(0, 2))
    return ((a - b).abs().amax(dim=(0, 2))
            / torch.where(scale > 0, scale, torch.ones_like(scale)))


def outer_ss_plan(order: int = ORDER):
    """The north-star tape: ``nbody(6)`` at bench.py's masses and G."""
    return build_plan(taylor_decompose_sys(
        nbody(6, masses=MASSES, Gconst=GCONST)), order)


def _setup(device, n_lanes: int, lo: int):
    """The tables and buffers of :func:`run` and :func:`sweep`: T2's and
    B4's tapes, the realistic buffer in the prototype's layout and in B4's,
    and B4's f64 copy of the latter."""
    dev = cuda_device(device)
    plan = outer_ss_plan()
    arrays = plan_to_arrays(plan)
    tc_in = realistic_buffer(plan, IC, n_lanes, lo, dev)
    return (plan, arrays, ProtoTape(arrays, dev), jp.PhaseTape(arrays, dev),
            tc_in, tc_in.permute(1, 0, 2).contiguous())


def run(device="cuda", n_lanes: int = B, lo: int = LO) -> dict:
    """The prototype's ``main`` on the card: kernel T2 on the realistic
    buffer against the plain body (:data:`RTOL` per order, else
    RuntimeError; the prototype's max abs diff and scale), kernel B4 in f64
    from ``lo`` on the same buffer at the same layout, the per-order
    relative difference of T2's orders ``lo..K`` against B4's, the times
    in the order plain, T2, B4, B4, T2, plain (CUDA events; the kernels'
    replayed from a CUDA graph), both kernels' block shapes, and both
    bounds."""
    plan, arrays, tape, tape64, tc_in, tc_k = _setup(device, n_lanes, lo)
    body = phase_body_plain(plan, lo, ORDER, plan.n_eq)
    ref = body(tc_in)
    out = phase_f32(tape, tc_k.clone(), lo)
    torch.cuda.synchronize()
    got = out.permute(1, 0, 2)
    rel = per_order_rel(got, ref)[lo:]
    if not (bool(torch.isfinite(got).all()) and float(rel.max()) <= RTOL):
        raise RuntimeError(f"hy_proto_phase_f32 vs phase_body_plain: per "
                           f"order {rel.tolist()}")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())

    # B4 in f64 from lo on the same orders 0..lo-1
    tc64 = tc_k.double()
    jp.phase(tape64, tc64, lo)
    torch.cuda.synchronize()
    vs64 = per_order_rel(got, tc64.permute(1, 0, 2))[lo:]

    fns = {"plain": lambda: body(tc_in),
           "kernel": lambda: phase_f32(tape, out, lo),
           "b4": lambda: jp.phase(tape64, tc64, lo)}
    t = {name: [] for name in fns}
    for name in ("plain", "kernel", "b4", "b4", "kernel", "plain"):
        t[name].append(cuda_ms(fns[name], 1, warmup=False) if name == "plain"
                       else graph_ms(fns[name], 5))
    tables = nbytes(tape.itab, tape.dtab)
    return dict(
        W=plan.width, K=ORDER, B=n_lanes, lo=lo, tol=RTOL,
        max_rel_per_order=float(rel.max()), max_abs_err=err, scale=scale,
        f32_vs_f64_rel_per_order=vs64.tolist(),
        ms=sum(t["kernel"]) / 2, plain_ms=sum(t["plain"]) / 2,
        b4_f64_ms=sum(t["b4"]) / 2, runs_ms=t,
        shape=jp.layout_report(tape, n_lanes, 4),
        b4_shape=jp.layout_report(tape64, n_lanes, 8),
        **bound(phase_flops(arrays, lo) * n_lanes,
                phase_bytes(arrays, n_lanes, lo, 4) + tables, _F32),
        b4_f64=bound(phase_flops(arrays, lo) * n_lanes,
                     phase_bytes(arrays, n_lanes, lo, 8) + tables,
                     torch.float64))


def sweep(device="cuda", n_lanes: int = B, lo: int = LO) -> dict:
    """Kernel T2 on :func:`run`'s buffer at every block shape of
    ``jet_phase.sweep_shapes`` over :data:`SWEEP_LANES`, forced (each equal
    to the default bit for bit, else RuntimeError), with its times (a CUDA
    graph's replay) and the fastest."""
    _, _, tape, _, _, tc_k = _setup(device, n_lanes, lo)
    out = phase_f32(tape, tc_k.clone(), lo)
    shapes = {}
    for lay, L, nt in jp.sweep_shapes(tape, 4, SWEEP_LANES):
        got = _phase_f32_cuda(tape, tc_k.clone(), lo, L, nt, lay)
        if not torch.equal(got, out):
            raise RuntimeError(f"hy_proto_phase_f32 with {L} lanes x {nt} "
                               f"threads on {lay} differs from the default "
                               f"shape")
        shapes[f"{lay}:{L}x{nt}"] = graph_ms(
            lambda: _phase_f32_cuda(tape, out, lo, L, nt, lay), 3)
    return dict(shapes_ms=shapes, fastest=min(shapes, key=shapes.get))


def main():
    dev = cuda_device("cuda")
    print(smi_line(), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      **run(dev), **sweep(dev)}), flush=True)


if __name__ == "__main__":
    main()
