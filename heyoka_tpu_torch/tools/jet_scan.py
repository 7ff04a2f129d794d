"""Kernel B2 on the outer-Solar-System tape at 10,240 lanes: its time
against the blocks an SM holds and against the order K.

    python -m heyoka_tpu_torch.tools.jet_scan

B2 (``jet_kernels.jet``, the jets in shared memory, one lane of 256
threads a block at every order) is
timed with CUDA events (a warm-up, then the mean of 5 launches):

- at order 19 with each block asking for more shared memory than it uses,
  so that an SM holds 3 (none added), 2 or 1 of them;
- at orders 4, 8, 12, 16 and 19, each block asking for the shared memory
  of an order-19 block, so that an SM holds 3 of them at every order;
- at order 19 on one lane: one block alone on the card (the mean of 20).

If the time falls as the blocks an SM holds rise, and one block alone
takes as long as one wave of blocks under a full load (``wave_ms``: the
full load's time over its waves of SMs x blocks an SM), a block's chain
of passes is latency-bound; the order scan splits the time into a part
that grows with K (passes of fixed cost) and one that grows with K^2 (the
sums of up to k+1 terms).  Prints the ``nvidia-smi`` line and one JSON line;
fails without a card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import GCONST, IC, MASSES, cuda_device, cuda_ms, smi_line

B = 10_240
ORDERS = (4, 8, 12, 16, 19)
BLOCKS_PER_SM = (3, 2, 1)
#: the block shape at every order: the outer SS's at order 19
#: (``jet_kernels.block_shape``)
LANES, THREADS = 1, 256


def pad_for(blocks: int, smem: int) -> int:
    """Bytes to add to a block of ``smem`` bytes so that an SM holds
    ``blocks`` of them (and no more); raises where it already holds
    fewer, or where the padded block would not fit."""
    from ..taylor import jet_kernels as jk

    need = jk.SM_SMEM // (blocks + 1) + 1 - jk.BLOCK_RESERVED
    pad = max(0, need - smem)
    if jk.blocks_per_sm(smem + pad, THREADS) != blocks \
            or smem + pad > jk.SMEM_MAX:
        raise ValueError(f"no padding of a {smem}-byte block gives "
                         f"{blocks} blocks an SM")
    return pad


def run(device="cuda") -> dict:
    import heyoka_tpu_torch as ht
    from ..taylor import jet_kernels as jk
    from ..taylor.compact import build_plan

    dev = cuda_device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    sys_ = ht.models.nbody(6, masses=MASSES, Gconst=GCONST)
    tapes = {K: jk.JetTape(ht.plan_to_arrays(build_plan(
        ht.taylor_decompose_sys(sys_), K)), dev) for K in ORDERS}
    rng = np.random.default_rng(2)
    st = torch.as_tensor((IC[None] + np.abs(IC)[None] * rng.uniform(
        -1, 1, (B, IC.size)) * 1e-8).T.copy(), **f64)
    pars = torch.zeros((0, B), **f64)
    top = tapes[max(ORDERS)]
    # an order-19 block's bytes
    full = jk._launch_cfg(top, B, dev, LANES, THREADS)[2]

    def ms(tape, pad):
        return cuda_ms(lambda: jk._jet_cuda(tape, st, pars, None, LANES,
                                            THREADS, pad), 5)

    occ = {}
    for n in BLOCKS_PER_SM:
        pad = pad_for(n, full)
        occ[n] = dict(ms=ms(top, pad), smem_bytes=full + pad)
    order = {}
    for K, tape in tapes.items():
        own = jk._launch_cfg(tape, B, dev, LANES, THREADS)[2]
        order[K] = dict(ms=ms(tape, full - own), smem_bytes=full)
    one = (st[:, :1].contiguous(), pars[:, :1].contiguous())
    alone = cuda_ms(lambda: jk.jet(top, *one), 20)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = -(-B // (LANES * sms * jk.blocks_per_sm(full, THREADS)))
    return dict(B=B, lanes_per_block=LANES, threads=THREADS,
                blocks_per_sm=occ, order=order, one_lane_ms=alone,
                sms=sms, waves=waves, wave_ms=occ[3]["ms"] / waves,
                device=torch.cuda.get_device_name(dev))


if __name__ == "__main__":
    print(smi_line(), flush=True)
    print(json.dumps(run()), flush=True)
