"""Kernel T1: the order-k Cauchy convolution microbenchmark, in f32 and in
two-f32 (double-float) pairs.

The counterpart of ``tools/microbench_pallas_conv.py``: ``c_k = sum_{j<=k}
a_j b_{k-j}`` for ``k < K`` on ``(K, N)`` arrays with the lane index minor,
at the tool's shapes (K = 20, N = M B = 20 x 10,240 = 204,800).

- :func:`conv_f32` / :func:`conv_dd`: the wrappers.  A CPU tensor runs
  the plain version; a CUDA tensor launches ``hy_conv_f32`` /
  ``hy_conv_dd`` (``csrc/conv_microbench.cu``) or raises.  They replace
  ``conv_pallas_f32`` (:45, ``pallas_call`` :48) and ``conv_pallas_dd``
  (:89, ``pallas_call`` :92);
- :func:`conv_f32_plain` / :func:`conv_dd_plain`: the tool's arithmetic
  (``conv_kernel_f32`` :35, ``conv_kernel_dd`` :64-86) in its order, in
  torch;
- :func:`conv_f64`: the f64 accuracy reference (the tool's host-side numpy
  loop, :122-125), in torch f64 on the inputs' device;
- :func:`conv_shape`: the launch of T1-dd's persistent ring (lanes a
  tile, blocks), pure Python; :func:`conv_dd_direct`: the ring's
  yardstick, the same lane body over plain loads;
- :func:`run`: the tool's ``main`` on the card; :func:`sweep`: T1-dd and
  its yardstick at every tile; :func:`trace`: where T1-dd's time goes,
  per tile, from the kernel's clock readings.

``python -m heyoka_tpu_torch.tools.microbench_conv`` runs all three on
the card and prints the result as one JSON line; it fails without a card.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..taylor.jet_kernels import (
    BLOCK_RESERVED, LAUNCHES, SM_SMEM, SM_THREADS, _check, _ptr,
)
from ..taylor.jet_phase import SM_BLOCKS, SMS, _sms
from . import cuda_device, cuda_ms, graph_ms, smi_line
from .roofline import bound, nbytes

K = 20
M = 20
B = 10_240
N = M * B  # 204,800
SPLIT = 4097.0  # Dekker's splitter for f32, 2^12 + 1

#: kernel vs plain version, relative to max(1, |c|) as the tool normalises
#: (:142): the f32 kernel sums in the plain version's order without FMA,
#: so the two should be equal
F32_RTOL = 1e-6
#: the two-f32 kernel vs its plain version: hi + lo in f64, relative to
#: max(1, |c|); the pair carries ~48 bits, and the kernel repeats the
#: plain arithmetic exactly
DD_RTOL = 1e-12

_F32 = torch.float32

#: kernel T1-dd's ring (csrc/conv_microbench.cu ``conv_dd_ring``): the
#: lanes a tile the rule chooses among (one thread a lane, whole warps),
#: and the source's limits (``kMaxThreads`` threads a block, ``kMaxRegs``
#: registers a thread, ptxas's most, which a lane's 160 inputs and splits
#: take; ``kBarBytes`` of mbarrier and read count before the stage)
TILES = (32, 64, 128)
MAX_THREADS, MAX_REGS, BAR_BYTES = 128, 255, 128
#: the ring's inputs: ahi, alo, bhi, blo
DD_IN = 4
#: tiles a block records in the ring's trace (csrc ``kTraceTiles``)
TRACE_TILES = 8
#: registers an SM holds
SM_REGS = 65_536

# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def conv_f32_plain(a, b):
    """``c_k = a_0 b_k + a_1 b_{k-1} + ... + a_k b_0`` for every k < K, in
    the tool's order (``conv_kernel_f32``)."""
    out = torch.empty_like(a)
    for k in range(a.shape[0]):
        c = a[0] * b[k]
        for j in range(1, k + 1):
            c = c + a[j] * b[k - j]
        out[k] = c
    return out


def _two_sum(x, y):
    s = x + y
    bb = s - x
    return s, (x - (s - bb)) + (y - bb)


def _split(x):
    t = SPLIT * x
    h = t - (t - x)
    return h, x - h


def conv_dd_plain(ahi, alo, bhi, blo):
    """The two-f32 convolution ``(ahi, alo) * (bhi, blo) -> (chi, clo)``
    with the tool's Dekker-split products, error terms and two-sum
    accumulation, in its order (``conv_kernel_dd``)."""
    ah, al = _split(ahi)
    bh, bl = _split(bhi)
    chi, clo = torch.empty_like(ahi), torch.empty_like(ahi)
    for k in range(ahi.shape[0]):
        shi = torch.zeros_like(ahi[0])
        slo = torch.zeros_like(ahi[0])
        for j in range(k + 1):
            m = k - j
            p = ahi[j] * bhi[m]
            e = (((ah[j] * bh[m] - p) + ah[j] * bl[m]) + al[j] * bh[m]) \
                + al[j] * bl[m]
            e = (e + ahi[j] * blo[m]) + alo[j] * bhi[m]
            shi, e2 = _two_sum(shi, p)
            slo = slo + (e + e2)
        chi[k], clo[k] = _two_sum(shi, slo)
    return chi, clo


def conv_f64(a, b):
    """The f64 accuracy reference: ``c_k += a_j b_{k-j}`` from zero, as the
    tool's host loop does."""
    c = torch.zeros_like(a)
    for k in range(a.shape[0]):
        for j in range(k + 1):
            c[k] += a[j] * b[k - j]
    return c


def conv_library(a, b):
    """The one PyTorch call that computes :func:`conv_f32`'s function: a
    grouped ``conv1d`` with one group per lane, the flipped ``a`` as the
    weight and ``b`` left-padded by K-1.  A yardstick only; the port never
    calls it.  Returns ``fn``: ``fn()`` is the call, on inputs laid out
    once beforehand, and gives ``c`` as ``(1, N, K)``."""
    Kc, n = a.shape
    x = torch.nn.functional.pad(b.t()[None], (Kc - 1, 0)).contiguous()
    w = a.t().flip(1)[:, None, :].contiguous()

    def fn():
        return torch.nn.functional.conv1d(x, w, groups=n)
    return fn


# ---------------------------------------------------------------------------
# the ring's shape
# ---------------------------------------------------------------------------

class ConvShape(NamedTuple):
    """A launch of kernel T1-dd: ``tile`` lanes a tile (one thread each),
    the block's dynamic shared memory ``smem`` (bytes), the
    ``blocks_per_sm`` the launch counts on and its persistent ``blocks``."""
    tile: int
    smem: int
    blocks_per_sm: int
    blocks: int


def ring_smem(tile: int) -> int:
    """Dynamic shared memory of a block: the ring's bookkeeping, then one
    tile of the four inputs' K rows."""
    return BAR_BYTES + DD_IN * K * tile * 4


def ring_blocks_per_sm(tile: int) -> int:
    """Blocks an SM holds as far as shared memory, threads and registers
    (:data:`MAX_REGS` a thread) limit them."""
    regs = -(-MAX_REGS // 8) * 8  # a thread's registers, in units of 8
    return min(SM_SMEM // (ring_smem(tile) + BLOCK_RESERVED),
               SM_THREADS // tile, SM_REGS // (regs * tile), SM_BLOCKS)


def conv_shape(n: int, tile=None, sms: int = SMS) -> ConvShape:
    """The launch of kernel T1-dd on ``n`` lanes: as many blocks as the
    ``sms`` SMs hold, or one a tile where there are fewer tiles; ``tile``
    as given, else the one of :data:`TILES` whose busiest SM processes the
    fewest lanes (its blocks, up to what it holds, each taking its share of
    the tiles in turn), the largest on a tie."""
    if n < 1:
        raise ValueError(f"kernel T1-dd takes 1 lane or more, not {n}")

    def launch(T):
        per_sm = ring_blocks_per_sm(T)
        tiles = -(-n // T)
        blocks = min(tiles, per_sm * sms)
        busiest = min(per_sm, -(-blocks // sms)) * -(-tiles // blocks) * T
        return busiest, ConvShape(T, ring_smem(T), per_sm, blocks)

    if tile is not None:
        if int(tile) not in TILES:
            raise ValueError(f"kernel T1-dd takes tiles of {TILES} lanes, "
                             f"not {tile}")
        return launch(int(tile))[1]
    return min((launch(T) for T in TILES),
               key=lambda c: (c[0], -c[1].tile))[1]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _device(*xs):
    dev = xs[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _checked(names, xs, dev):
    Kc = xs[0].shape[0] if xs[0].ndim == 2 else 0
    n = xs[0].shape[1] if xs[0].ndim == 2 else 0
    for name, x in zip(names, xs):
        _check(name, x, (Kc, n), _F32, dev)
    if Kc != K:
        raise ValueError(f"the kernel is built for the tool's K = {K}; got "
                         f"K = {Kc}")
    return n


def conv_f32(a, b):
    """The f32 convolution of ``a, b (K, N)`` -> ``c (K, N)``.  A CPU
    tensor runs :func:`conv_f32_plain`; a CUDA tensor launches
    ``hy_conv_f32``."""
    dev = _device(a)
    if dev.type == "cpu":
        return conv_f32_plain(a, b)
    n = _checked(("a", "b"), (a, b), dev)
    c = torch.empty_like(a)
    if n == 0:
        return c
    rc = _build.load().hy_conv_f32(
        _ptr(a), _ptr(b), _ptr(c), n, K,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hy_conv_f32 launch failed: CUDA error {rc}")
    LAUNCHES["conv_f32"] += 1
    return c


def conv_dd(ahi, alo, bhi, blo):
    """The two-f32 convolution of ``(ahi, alo), (bhi, blo)`` (each ``(K,
    N)`` f32) -> ``(chi, clo)``.  A CPU tensor runs :func:`conv_dd_plain`;
    a CUDA tensor launches ``hy_conv_dd`` at :func:`conv_shape`'s
    launch."""
    dev = _device(ahi)
    if dev.type == "cpu":
        return conv_dd_plain(ahi, alo, bhi, blo)
    return _conv_dd_cuda(ahi, alo, bhi, blo)


def _conv_dd_cuda(ahi, alo, bhi, blo, tile=None, trace=None):
    """``hy_conv_dd`` on CUDA tensors at :func:`conv_shape`'s launch for
    the given ``tile`` (None: the rule's); with ``trace``, a zeroed int64
    tensor of ``(blocks, TRACE_TILES, 4)``, ``hy_conv_dd_trace``, which
    also writes the kernel's clock readings there (:func:`trace`)."""
    if trace is None:
        out = _launch_dd("hy_conv_dd", (ahi, alo, bhi, blo), tile)
    else:
        out = _launch_dd("hy_conv_dd_trace", (ahi, alo, bhi, blo), tile,
                         _ptr(trace))
    LAUNCHES["conv_dd"] += 1
    return out


def conv_dd_direct(ahi, alo, bhi, blo, tile=None):
    """The ring's yardstick on CUDA tensors: ``hy_conv_dd_direct``, the
    ring's lane body in the same persistent loop at the same launch, each
    lane's inputs loaded straight from global memory (no shared memory,
    no copies in flight).  Not on the tool's path: a comparison only.  A
    CPU tensor runs :func:`conv_dd_plain`."""
    if _device(ahi).type == "cpu":
        return conv_dd_plain(ahi, alo, bhi, blo)
    return _launch_dd("hy_conv_dd_direct", (ahi, alo, bhi, blo), tile)


def _launch_dd(entry, xs, tile, *extra):
    dev = _device(*xs)
    n = _checked(("ahi", "alo", "bhi", "blo"), xs, dev)
    chi, clo = torch.empty_like(xs[0]), torch.empty_like(xs[0])
    if n == 0:
        return chi, clo
    sh = conv_shape(n, tile, _sms(dev))
    rc = getattr(_build.load(), entry)(
        *(_ptr(x) for x in xs), _ptr(chi), _ptr(clo), n, K, sh.tile,
        sh.blocks, *extra, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    return chi, clo


def occupancy(tile: int) -> int:
    """Blocks of kernel T1-dd an SM holds at ``tile`` lanes as the CUDA
    runtime counts them (registers included); on the card."""
    got = _build.load().hy_conv_dd_occupancy(tile)
    if got < 0:
        raise RuntimeError(f"hy_conv_dd_occupancy failed: CUDA error {-got}")
    return got


# ---------------------------------------------------------------------------
# the tool
# ---------------------------------------------------------------------------

def inputs(n: int = N, seed: int = 0):
    """The tool's inputs (numpy): ``a64, b64 (K, n)`` standard normal from
    ``default_rng(seed)``, and their f32 hi/lo splits ``(ahi, alo, bhi,
    blo)``."""
    rng = np.random.default_rng(seed)
    a64 = rng.standard_normal((K, n))
    b64 = rng.standard_normal((K, n))
    ahi = a64.astype(np.float32)
    alo = (a64 - ahi.astype(np.float64)).astype(np.float32)
    bhi = b64.astype(np.float32)
    blo = (b64 - bhi.astype(np.float64)).astype(np.float32)
    return a64, b64, (ahi, alo, bhi, blo)


def rel_err(c, ref):
    """max |c - ref| / max(1, |ref|), in f64 (the tool's measure, :142)."""
    c, ref = c.double(), ref.double()
    return float(((c - ref).abs() / ref.abs().clamp(min=1.0)).max())


def flops(n: int = N) -> dict:
    """Operations each function needs at ``(K, n)``: f32 K^2 a lane (k+1
    products and k adds at order k); two-f32 21 a term (13 for the product
    and its error, 6 for the two-sum, 2 for the low sum) over K (K+1)/2
    terms, less 8 an order for its first term, whose two-sum with the zero
    start is exact and needs none of them, plus 8 a coefficient for the
    splits and 6 an order for the last two-sum."""
    return dict(f32=K * K * n, dd=(21 * K * (K + 1) // 2 + 6 * K) * n)


def run(device="cuda", n: int = N) -> dict:
    """The tool's ``main`` on the card: both kernels on the seeded inputs
    (``launches``: the wrappers' launches of this first call, outside any
    CUDA graph), each checked against its plain version (:data:`F32_RTOL`,
    :data:`DD_RTOL`, else RuntimeError; ``same_bits_as_plain``) and
    against the f64 reference;
    times in the order plain, kernel, yardstick, yardstick, kernel, plain,
    the yardstick being the grouped ``conv1d`` for the f32 kernel (cuDNN's
    TF32 off) and :func:`conv_dd_direct` for T1-dd: ``ms``,
    ``dd_direct_ms`` and ``library_ms`` replayed from a CUDA graph
    (``graph_ms``: a kernel of a few tens of microseconds takes about as
    long as its launch from Python), ``cuda_ms`` and ``library_cuda_ms`` from CUDA events around
    back-to-back launches (the timer of the rows before); bounds."""
    dev = cuda_device(device)
    a64, b64, dd_np = inputs(n)
    a64_t, b64_t = (torch.as_tensor(x, device=dev) for x in (a64, b64))
    a32, b32 = a64_t.float(), b64_t.float()
    dd = tuple(torch.as_tensor(x, device=dev) for x in dd_np)
    c64 = conv_f64(a64_t, b64_t)

    before = dict(LAUNCHES)
    c32 = conv_f32(a32, b32)
    chi, clo = conv_dd(*dd)
    launches = {k: LAUNCHES[k] - before[k] for k in ("conv_f32", "conv_dd")}
    torch.cuda.synchronize()
    p32 = conv_f32_plain(a32, b32)
    phi, plo = conv_dd_plain(*dd)
    cdd, pdd = chi.double() + clo.double(), phi.double() + plo.double()
    f32_vs_plain, dd_vs_plain = rel_err(c32, p32), rel_err(cdd, pdd)
    if not (bool(torch.isfinite(c32).all()) and f32_vs_plain <= F32_RTOL):
        raise RuntimeError(f"hy_conv_f32 vs conv_f32_plain: {f32_vs_plain}")
    if not (bool(torch.isfinite(cdd).all()) and dd_vs_plain <= DD_RTOL):
        raise RuntimeError(f"hy_conv_dd vs conv_dd_plain: {dd_vs_plain}")
    same = {"f32": torch.equal(c32, p32),
            "dd": torch.equal(chi, phi) and torch.equal(clo, plo)}

    lib = conv_library(a32, b32)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib_rel = rel_err(lib()[0].t(), c32)
        runs = {"f32": {"plain": lambda: conv_f32_plain(a32, b32),
                        "kernel": lambda: conv_f32(a32, b32),
                        "library": lib},
                "dd": {"plain": lambda: conv_dd_plain(*dd),
                       "kernel": lambda: conv_dd(*dd),
                       "direct": lambda: conv_dd_direct(*dd)}}
        order = {"f32": ("plain", "kernel", "library", "library", "kernel",
                         "plain"),
                 "dd": ("plain", "kernel", "direct", "direct", "kernel",
                        "plain")}
        t = {}
        for which, fns in runs.items():
            t[which] = {name: [] for name in fns}
            t[which].update({f"{name}_cuda": [] for name in fns
                             if name != "plain"})
            for name in order[which]:
                if name == "plain":
                    t[which][name].append(cuda_ms(fns[name], 2))
                else:
                    t[which][name].append(graph_ms(fns[name], 20))
                    t[which][f"{name}_cuda"].append(cuda_ms(fns[name], 20))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    fl = flops(n)
    out = dict(K=K, N=n, cudnn_allow_tf32=False, timer="graph_ms",
               launches=launches, library_max_rel_vs_kernel=lib_rel,
               dd_shape=conv_shape(n, sms=_sms(dev))._asdict(),
               dd_direct_ms=sum(t["dd"]["direct"]) / 2)
    for which, c, p, err_plain, io in (
            ("f32", c32, p32, f32_vs_plain, (a32, b32, c32)),
            ("dd", cdd, pdd, dd_vs_plain, (*dd, chi, clo))):
        tw = t[which]
        ms = sum(tw["kernel"]) / 2
        lib_t = "library" in tw
        out[which] = dict(
            ms=ms, cuda_ms=sum(tw["kernel_cuda"]) / 2,
            plain_ms=sum(tw["plain"]) / 2,
            library_ms=sum(tw["library"]) / 2 if lib_t else None,
            library_cuda_ms=sum(tw["library_cuda"]) / 2 if lib_t else None,
            runs_ms=tw, rel_err_vs_f64=rel_err(c, c64),
            max_rel_vs_plain=err_plain, same_bits_as_plain=same[which],
            max_abs_err=float((c.double() - p.double()).abs().max()),
            gmacs_per_s=K * (K + 1) / 2 * n / ms / 1e6,
            **bound(fl[which], nbytes(*io), _F32))
    return out


def sweep(device="cuda", n: int = N) -> dict:
    """Kernel T1-dd and its yardstick :func:`conv_dd_direct` on
    :func:`run`'s inputs at every tile of :data:`TILES`, forced (each equal
    to the rule's launch bit for bit, else RuntimeError), with their times
    (a CUDA graph's replay), the ring's dynamic shared memory, the blocks
    an SM the rule counts and the CUDA runtime's count (registers
    included), and the fastest."""
    dev = cuda_device(device)
    dd = [torch.as_tensor(x, device=dev) for x in inputs(n)[2]]
    ref = conv_dd(*dd)
    tiles = {}
    for T in TILES:
        for name, fn in (("ring", _conv_dd_cuda), ("direct", conv_dd_direct)):
            got = fn(*dd, T)
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                raise RuntimeError(f"hy_conv_dd ({name}) at tile {T} "
                                   f"differs from the rule's launch")
        sh = conv_shape(n, T, _sms(dev))
        tiles[T] = dict(
            ms=graph_ms(lambda: _conv_dd_cuda(*dd, T), 20),
            direct_ms=graph_ms(lambda: conv_dd_direct(*dd, T), 20),
            smem=sh.smem, blocks_per_sm=sh.blocks_per_sm,
            occupancy=occupancy(T), blocks=sh.blocks)
    fastest = min(tiles, key=lambda k: tiles[k]["ms"])
    return dict(shape=conv_shape(n, sms=_sms(dev))._asdict(),
                tiles=tiles, fastest=fastest)


def trace(device="cuda", n: int = N, tile=None) -> dict:
    """Where kernel T1-dd's time goes, from the ring's clock readings
    (thread 0 of each block, the first :data:`TRACE_TILES` tiles, the
    global timer) on :func:`run`'s inputs at the rule's tile or the one
    given: per tile in the block's order, the mean microseconds waiting
    for its data, reading its lane and refilling the stage, and in the
    arithmetic; and when the blocks end (quantiles, from the first
    reading)."""
    dev = cuda_device(device)
    dd = [torch.as_tensor(x, device=dev) for x in inputs(n)[2]]
    sh = conv_shape(n, tile, _sms(dev))
    _conv_dd_cuda(*dd, tile)
    tr = torch.zeros((sh.blocks, TRACE_TILES, 4), dtype=torch.int64,
                     device=dev)
    _conv_dd_cuda(*dd, tile, trace=tr)
    torch.cuda.synchronize()
    t = tr.cpu().double()
    used = t[:, :, 0] > 0
    t = (t - t[:, 0, 0].min()) / 1e3
    steps = t.diff(dim=2)  # wait, read, arithmetic
    mean = [[float(steps[:, i, j][used[:, i]].mean()) if used[:, i].any()
             else None for i in range(TRACE_TILES)] for j in range(3)]
    ends = t[:, :, 3].where(used, torch.zeros(())).amax(1)
    return dict(shape=sh._asdict(), wait_us=mean[0], read_us=mean[1],
                arithmetic_us=mean[2], end_us={
                    q: float(ends.quantile(q)) for q in (0.1, 0.5, 0.9, 1.0)})


def main():
    dev = cuda_device("cuda")
    print(smi_line(), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      **run(dev), "dd_sweep": sweep(dev),
                      "dd_trace": trace(dev)}), flush=True)


if __name__ == "__main__":
    main()
