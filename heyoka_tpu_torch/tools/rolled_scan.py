"""Kernel B3 on mascon tapes: where its time goes, and which block shape.

    python -m heyoka_tpu_torch.tools.rolled_scan

B3 (``jet_rolled.jet_rolled``, one lane a block) at order 19, timed with
CUDA events (a warm-up, then the mean of 3 launches):

- on mascon-512, against the order K (2, 5, 10, 15, 19) at 1,024 lanes: a
  time linear in K is a fixed cost an order (its passes), a quadratic one
  the k-term products;
- on mascon-512, against the lanes (1, 132, 264, 1,024): one block alone
  against waves of blocks under a full load;
- on mascon-32, -128, -256 and -512 and the outer-Solar-System tape at
  1,024 lanes, at each block size on both layouts (the smem layout where
  a lane fits a block), each equal bit for bit to the default launch, and
  the shape ``jet_rolled.layout_report`` chooses;
- on mascon-512 without the literal aliases (full history, so the global
  layout) and without the warp sums (every sum a thread's);
- one traced launch at 1 and at 1,024 lanes of mascon-512 (``trace``: the
  SM clock after each barrier of block 0's first lane), summed by pass:
  order 0, the state rows and each level of the orders k >= 1, in cycles;
  and one lane of mascon-12 and mascon-128 traced the same way, whose
  levels hold 40 and 4 times fewer items: what a pass costs whatever its
  items.

Prints the ``nvidia-smi`` line and one JSON line; fails without a card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import (
    GCONST, IC, MASSES, cuda_device, cuda_ms, mascon_body, mascon_lanes,
    smi_line,
)

ORDERS = (2, 5, 10, 15, 19)
LANES = (1, 132, 264, 1024)
WIDTHS = (32, 128, 256)  # beside mascon-512
B = 1024
K = 19


def _arrays(sys_, order):
    import heyoka_tpu_torch as ht
    from ..taylor.compact import build_plan

    return ht.plan_to_arrays(build_plan(ht.taylor_decompose_sys(sys_), order))


def _mascon(n, order):
    import heyoka_tpu_torch as ht
    return _arrays(ht.models.mascon(**mascon_body(n)[0]), order)


def passes(tape, trace) -> dict:
    """A traced launch's clock readings (``jet_rolled.trace_len`` of them)
    as cycles by pass: ``seed``, ``order0`` (every level of order 0),
    ``state_rows`` and ``level<i>`` (summed over the orders k >= 1),
    ``end`` (norms and output) and ``total``."""
    from ..taylor.jet_rolled import _RHDR
    it = tape.ritab.cpu().numpy()
    h = dict(zip(_RHDR, it[:len(_RHDR)].tolist()))
    lvlk = it[h["lvlk"]:h["lvlk"] + h["n_levels"] + 1]
    busy = [i for i in range(h["n_levels"]) if lvlk[i + 1] > lvlk[i]]
    d = np.diff(np.asarray(trace.cpu(), np.int64)).tolist()
    n0 = h["n_levels"]
    out = dict(seed=d[0], order0=sum(d[1:1 + n0]))
    per_k = d[1 + n0:-1]
    width = 1 + len(busy)
    out["state_rows"] = sum(per_k[0::width])
    for j, lv in enumerate(busy):
        out[f"level{lv}"] = sum(per_k[1 + j::width])
    out["end"] = d[-1]
    out["total"] = sum(d)
    return out


def run(device="cuda") -> dict:
    from ..models import nbody
    from ..taylor import jet_rolled as jr

    dev = cuda_device(device)
    f64 = dict(dtype=torch.float64, device=dev)

    def args(st):
        n = st.shape[0]
        return (torch.as_tensor(st.T.copy(), **f64),
                torch.zeros((0, n), **f64), torch.zeros(n, **f64))

    tapes = {k: jr.RolledTape(_mascon(512, k), dev) for k in ORDERS}
    top = tapes[K]
    ics = mascon_lanes(mascon_body(512)[1], B)
    full = args(ics)
    order = {k: cuda_ms(lambda: jr.jet_rolled(t, *full), 3)
             for k, t in tapes.items()}
    lanes = {n: cuda_ms(lambda: jr.jet_rolled(top, *args(ics[:n])), 3)
             for n in LANES}

    wide = {f"mascon{n}": jr.RolledTape(_mascon(n, K), dev) for n in WIDTHS}
    wide["mascon512"] = top
    wide["outer_ss"] = jr.RolledTape(_arrays(
        nbody(6, masses=MASSES, Gconst=GCONST), K), dev)
    ss_lanes = IC[None] + np.abs(IC)[None] * (
        np.random.default_rng(3).uniform(-1, 1, (B, IC.size)) * 1e-8)
    shapes = {}
    for name, tape in wide.items():
        a = args(ss_lanes if name == "outer_ss"
                 else mascon_lanes(np.random.default_rng(1), B))
        ref = jr.jet_rolled(tape, *a)
        res = dict(W=tape.width, widest=tape.widest,
                   chosen=jr.layout_report(tape),
                   default_ms=cuda_ms(lambda: jr.jet_rolled(tape, *a), 3))
        for nt in jr.BLOCK_THREADS:
            for lay in ("smem", "global"):
                if jr.smem_bytes(tape, lay, nt) > jr.SMEM_MAX:
                    continue

                def launch():
                    return jr._jet_rolled_cuda(tape, *a, threads=nt,
                                               layout=lay)
                if not all(torch.equal(x, y) for x, y in zip(launch(), ref)):
                    raise AssertionError(f"{name}: {lay} x {nt} differs")
                res[f"{lay}x{nt}"] = cuda_ms(launch, 3)
        shapes[name] = res

    flat = jr.RolledTape(top.arrays, dev, _with_aliases=False)
    narrow = jr.RolledTape(top.arrays, dev, _wide_sum=1 << 30)
    variants = dict(
        no_aliases=dict(layout=jr.block_layout(flat)[0], ms=cuda_ms(
            lambda: jr.jet_rolled(flat, *full), 3)),
        no_warp_sums=dict(ms=cuda_ms(lambda: jr.jet_rolled(narrow, *full),
                                     3)))

    def trace(tape, st):
        tr = torch.zeros(jr.trace_len(tape), dtype=torch.int64, device=dev)
        jr._jet_rolled_cuda(tape, *args(st), trace=tr)
        torch.cuda.synchronize()
        return passes(tape, tr)

    traced = {n: trace(top, ics[:n]) for n in (1, B)}
    small = {f"mascon{m}": trace(jr.RolledTape(_mascon(m, K), dev), ics[:1])
             for m in (12, 128)}
    return dict(B=B, K=K, chosen=jr.layout_report(top), order_ms=order,
                lanes_ms=lanes, shapes_ms=shapes, variants=variants,
                trace_cycles=traced, trace_cycles_one_lane=small,
                device=torch.cuda.get_device_name(dev))


if __name__ == "__main__":
    print(smi_line(), flush=True)
    print(json.dumps(run()), flush=True)
