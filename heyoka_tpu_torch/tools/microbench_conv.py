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
- :func:`run`: the tool's ``main`` on the card.

``python -m heyoka_tpu_torch.tools.microbench_conv`` runs :func:`run` on
the card and prints its result as one JSON line; it fails without a card.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import _build
from ..taylor.jet_kernels import LAUNCHES, _check, _ptr
from . import cuda_device, cuda_ms, smi_line
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
    a CUDA tensor launches ``hy_conv_dd``."""
    dev = _device(ahi)
    if dev.type == "cpu":
        return conv_dd_plain(ahi, alo, bhi, blo)
    n = _checked(("ahi", "alo", "bhi", "blo"), (ahi, alo, bhi, blo), dev)
    chi, clo = torch.empty_like(ahi), torch.empty_like(ahi)
    if n == 0:
        return chi, clo
    rc = _build.load().hy_conv_dd(
        _ptr(ahi), _ptr(alo), _ptr(bhi), _ptr(blo), _ptr(chi), _ptr(clo),
        n, K, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hy_conv_dd launch failed: CUDA error {rc}")
    LAUNCHES["conv_dd"] += 1
    return chi, clo


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
    """The tool's ``main`` on the card: both kernels on the seeded inputs,
    each checked against its plain version (:data:`F32_RTOL`,
    :data:`DD_RTOL`, else RuntimeError) and against the f64 reference;
    times (CUDA events) in the order plain, kernel, kernel, plain, with the
    grouped ``conv1d`` beside the f32 kernel (cuDNN's TF32 off); bounds."""
    dev = cuda_device(device)
    a64, b64, dd_np = inputs(n)
    a64_t, b64_t = (torch.as_tensor(x, device=dev) for x in (a64, b64))
    a32, b32 = a64_t.float(), b64_t.float()
    dd = tuple(torch.as_tensor(x, device=dev) for x in dd_np)
    c64 = conv_f64(a64_t, b64_t)

    c32 = conv_f32(a32, b32)
    chi, clo = conv_dd(*dd)
    torch.cuda.synchronize()
    p32 = conv_f32_plain(a32, b32)
    phi, plo = conv_dd_plain(*dd)
    cdd, pdd = chi.double() + clo.double(), phi.double() + plo.double()
    f32_vs_plain, dd_vs_plain = rel_err(c32, p32), rel_err(cdd, pdd)
    if not (bool(torch.isfinite(c32).all()) and f32_vs_plain <= F32_RTOL):
        raise RuntimeError(f"hy_conv_f32 vs conv_f32_plain: {f32_vs_plain}")
    if not (bool(torch.isfinite(cdd).all()) and dd_vs_plain <= DD_RTOL):
        raise RuntimeError(f"hy_conv_dd vs conv_dd_plain: {dd_vs_plain}")

    lib = conv_library(a32, b32)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib_rel = rel_err(lib()[0].t(), c32)
        runs = {"f32": {"plain": lambda: conv_f32_plain(a32, b32),
                        "kernel": lambda: conv_f32(a32, b32),
                        "library": lib},
                "dd": {"plain": lambda: conv_dd_plain(*dd),
                       "kernel": lambda: conv_dd(*dd)}}
        reps = {"plain": 2, "kernel": 20, "library": 20}
        order = {"f32": ("plain", "kernel", "library", "library", "kernel",
                         "plain"),
                 "dd": ("plain", "kernel", "kernel", "plain")}
        t = {}
        for which, fns in runs.items():
            t[which] = {name: [] for name in fns}
            for name in order[which]:
                t[which][name].append(cuda_ms(fns[name], reps[name]))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    fl = flops(n)
    out = dict(K=K, N=n, cudnn_allow_tf32=False,
               library_max_rel_vs_kernel=lib_rel)
    for which, c, p, err_plain, io in (
            ("f32", c32, p32, f32_vs_plain, (a32, b32, c32)),
            ("dd", cdd, pdd, dd_vs_plain, (*dd, chi, clo))):
        tw = t[which]
        ms = sum(tw["kernel"]) / 2
        out[which] = dict(
            ms=ms, plain_ms=sum(tw["plain"]) / 2,
            library_ms=sum(tw["library"]) / 2 if "library" in tw else None,
            runs_ms=tw, rel_err_vs_f64=rel_err(c, c64),
            max_rel_vs_plain=err_plain,
            max_abs_err=float((c.double() - p.double()).abs().max()),
            gmacs_per_s=K * (K + 1) / 2 * n / ms / 1e6,
            **bound(fl[which], nbytes(*io), _F32))
    return out


def main():
    dev = cuda_device("cuda")
    print(smi_line(), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      **run(dev)}), flush=True)


if __name__ == "__main__":
    main()
