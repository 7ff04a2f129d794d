"""What kernel S1-L spends its time on: variants of its source timed on
the complete ELP2000's class-L terms (35,228 terms at K = 19, 10,240
lanes, ``u0`` from U(-0.5, 0.5), ``u1 = 1``), each built by ``nvcc`` into
its own library beside the kernels' (``_build.build_dir() /
"series_scan"``) and launched through ``hy_series_lin_f64``:

- ``kernel``: ``csrc/series_jet.cu`` as it is;
- ``library_sincos``: the library's ``sincos`` in place of
  ``lin_sincos``;
- ``no_products``: the products replaced by four adds of the B fragment
  into an accumulator (the sincos kept live);
- ``no_sincos``: the sincos replaced by a multiply (the products kept).

Run on the card: ``python -m heyoka_tpu_torch.tools.series_scan``.  It
prints the card's ``nvidia-smi`` line, then one JSON line: each
variant's registers a thread (ptxas), its error against the twin's
closed form over each order's summed term magnitudes (the two cut
variants compute something else) and its time in two rounds
(``tools.cuda_ms``, five launches each).  Without a card it fails."""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from .. import _build
from ..taylor import series_jet as sj
from . import cuda_ms, smi_line

#: the lines of ``csrc/series_jet.cu`` the variants replace
MMA_EVEN = "mma_f64(acc[0][mt][j], a[0][mt], bs);"
MMA_ODD = "if (odd) mma_f64(acc[1][mt][j], a[1][mt], bc);"
SINCOS = "lin_sincos(__dadd_rn(p0[v], __dmul_rn(u0[j], p1[v])), bs[v],"
VARIANTS = ("kernel", "library_sincos", "no_products", "no_sincos")


def variant_source(tag: str, src: str) -> str:
    """The source of variant ``tag`` (``VARIANTS``) made from ``src``;
    ValueError where a line it replaces is missing."""
    for line in (MMA_EVEN, MMA_ODD, SINCOS):
        if line not in src:
            raise ValueError(f"csrc/series_jet.cu has no line {line!r}")
    if tag == "library_sincos":
        return src.replace(SINCOS, "sincos_ref(__dadd_rn(p0[v], __dmul_rn("
                           "u0[j], p1[v])), bs[v],").replace(
            "namespace {\n", "namespace {\n__device__ __forceinline__ void "
            "sincos_ref(double x, double& s, double& c) {\n  sincos(x, &s, "
            "&c);\n}\n", 1)
    if tag == "no_products":
        return src.replace(MMA_EVEN, "acc[0][mt][j][0] += bs[0] + bs[1] + "
                           "bs[2] + bs[3];").replace(
            MMA_ODD, "acc[1][mt][j][0] += bc[0] + bc[1] + bc[2] + bc[3];")
    if tag == "no_sincos":
        return src.replace(SINCOS, "fake_sincos(__dadd_rn(p0[v], __dmul_rn("
                           "u0[j], p1[v])), bs[v],").replace(
            "namespace {\n", "namespace {\n__device__ __forceinline__ void "
            "fake_sincos(double x, double& s, double& c) {\n  s = x;\n  c = "
            "x * 0.5;\n}\n", 1)
    if tag != "kernel":
        raise ValueError(f"unknown variant {tag!r}")
    return src


def build(tag: str):
    """Variant ``tag``'s ``hy_series_lin_f64`` and S1-L's registers a
    thread (its two instances, ``MT`` 2 and 1, in ptxas's order)."""
    out = _build.build_dir() / "series_scan"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{tag}.cu"
    cu.write_text(variant_source(
        tag, (_build.CSRC / "series_jet.cu").read_text()))
    so = out / f"lib{tag}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(so), str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {tag}:\n{r.stderr[-3000:]}")
    regs, fn_name = [], ""
    for ln in (r.stdout + r.stderr).splitlines():
        if "Compiling entry function" in ln:
            fn_name = ln
        elif "Used" in ln and "series_lin_kernel" in fn_name:
            regs.append(int(ln.split("Used ")[1].split()[0]))
    fn = ctypes.CDLL(str(so)).hy_series_lin_f64
    fn.argtypes = list(_build.SIGNATURES["hy_series_lin_f64"])
    fn.restype = ctypes.c_int
    return fn, regs


def run(B: int = 10_240, K: int = 19, rounds: int = 2) -> dict:
    """Every variant on the ELP2000's class L at ``B`` lanes and order
    ``K``, timed in ``rounds`` rounds of the variants in turn."""
    import heyoka_tpu_torch as ht
    from .cases import elp_sys

    if not torch.cuda.is_available():
        raise SystemExit("series_scan: no CUDA device")
    dev = torch.device("cuda")
    names = [op.op for op in ht.taylor_decompose_sys(elp_sys(ht, 0.0)).ops
             if op.op.startswith("trigseries%")]
    work = sj.work_of([sj.tables_on(nm, dev) for nm in names], K)
    n = len(names)
    u0 = torch.as_tensor(np.random.default_rng(24).uniform(-0.5, 0.5, B),
                         device=dev)
    U0 = u0.expand(n, -1).contiguous()
    U1 = torch.ones_like(U0)
    wl, lin, _, sstart = work.launch_items(B, "lin", 132)
    tiles, _ = work.packs()
    dst = work.dst(range(n))
    out = U0.new_empty((K + 1, n, B))
    part = U0.new_empty((wl.n_slots, K + 1, B))
    got = [sj._closed_form(sp, U0[i], U1[i], K, True)
           for i, sp in enumerate(work.splits)]
    want = torch.stack([f for f, _ in got], 1)
    scale = torch.stack([m for _, m in got], 1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    mt = sj.lin_row_tiles(K)

    def launch(fn):
        rc = fn(tiles.data_ptr(), lin.data_ptr(), wl.lin.shape[0],
                U0.data_ptr(), U1.data_ptr(), part.data_ptr(), B, K, mt,
                sj.lin_smem(mt), sstart.data_ptr(), dst.data_ptr(),
                out.data_ptr(), n, n, stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    fns = {tag: build(tag) for tag in VARIANTS}
    res = {tag: dict(registers=regs, ms=[]) for tag, (_, regs) in
           fns.items()}
    for _ in range(rounds):
        for tag, (fn, _) in fns.items():
            res[tag]["ms"].append(cuda_ms(lambda: launch(fn), 5))
            launch(fn)
            torch.cuda.synchronize()
            res[tag]["max_err_of_scale"] = float(
                ((out - want).abs() / scale).max())
    return dict(B=B, K=K, terms=sum(sp.lin.size for sp in work.splits),
                variants=res)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("series_scan: no CUDA device")
    smi = smi_line()
    print(smi, flush=True)
    print(json.dumps(dict(nvidia_smi=smi, **run())), flush=True)


if __name__ == "__main__":
    main()
