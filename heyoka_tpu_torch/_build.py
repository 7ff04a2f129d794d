"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` file, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, at first use, into ``build/heyoka_tpu_torch/`` at the
root of the checkout (listed in ``.gitignore``).  The library's file name
carries a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the last build.  ``ctypes`` loads it; every entry
point returns ``cudaGetLastError()`` after its launch.

There is no fallback: without ``nvcc`` or with a failing build, ``load``
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "heyoka_tpu_torch"

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
#: compile flags: ``-fmad=false`` keeps nvcc from contracting ``a*b - c``
#: into an FMA, so the compensated sums and the convolutions round like
#: their plain torch twins; ``-Xptxas -v`` writes registers and spills into
#: the build log
NVCC_FLAGS = (
    *_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
#: C entry points and their argument types (pointers and the stream as
#: c_void_p: ctypes would pass a bare Python int as a 32-bit int)
SIGNATURES = {
    # itab, dtab, state, pars, t, tc, out, norms, B, lanes, threads, smem,
    # n_it, n_dt, stream
    "hy_jet_f64": (_P,) * 8 + (_I,) * 6 + (_P,),
    # itab, dtab, state, pars, aux, auxi, tc, state_out, of, oi,
    # B, n_steps, high_accuracy, lanes, threads, smem, n_it, n_dt, stream
    "hy_prop_f64": (_P,) * 10 + (_I,) * 8 + (_P,),
    # itab, dtab, state, pars, t, scratch, V, out, norms, trace, B,
    # threads, smem, lane_dbl, blocks, stream
    "hy_jet_rolled_f64": (_P,) * 10 + (_I,) * 5 + (_P,),
    # itab, dtab, tc, syn, ser, n_ser, B, lo, lanes, threads, smem, n_it,
    # n_dt, global layout, stream (csrc/phase_block.cuh)
    "hy_phase_f64": (_P,) * 5 + (_I,) * 9 + (_P,),
    # itab, dtab, tc, B, lo, lanes, threads, smem, n_it, n_dt, stream
    "hy_phase_stage_f64": (_P,) * 3 + (_I,) * 7 + (_P,),
    # a, b, c, N, K, stream
    "hy_conv_f32": (_P,) * 3 + (_I, _I, _P),
    # ahi, alo, bhi, blo, chi, clo, N, K, tile, blocks, stream
    "hy_conv_dd": (_P,) * 6 + (_I,) * 4 + (_P,),
    # the same with the trace before the stream
    "hy_conv_dd_trace": (_P,) * 6 + (_I,) * 4 + (_P, _P),
    # the arguments of hy_conv_dd
    "hy_conv_dd_direct": (_P,) * 6 + (_I,) * 4 + (_P,),
    # tile
    "hy_conv_dd_occupancy": (_I,),
    # itab, dtab, tc, syn, B, lo, lanes, threads, smem, n_it, n_dt,
    # global layout, stream
    "hy_proto_phase_f32": (_P,) * 4 + (_I,) * 8 + (_P,),
    # amp, ph, u0, u1, out, part, n, q1, d1, B, K, per, chunks, smem,
    # stream (csrc/series_jet.cu)
    "hy_series_jet_f64": (_P,) * 6 + (_I,) * 8 + (_P,),
}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        from torch.utils.cpp_extension import CUDA_HOME

        cand = Path(CUDA_HOME or "") / "bin" / "nvcc"
        exe = str(cand) if CUDA_HOME and cand.exists() else None
    if exe is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME): the "
            "port's CUDA kernels are built from heyoka_tpu_torch/csrc at "
            "first use and need the CUDA toolkit")
    return exe


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libhy_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the current sources are already built;
    return the library's path.  The compilers' output goes beside it
    (``.log``)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.name}.{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}.tmp"
    objs, jobs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        objs.append(BUILD_DIR / f"{tag}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs[-1]), str(src)]
        jobs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, err = [], ""
    for cmd, p in jobs:
        so, se = p.communicate()
        log.append(" ".join(cmd) + "\n" + so + se)
        if p.returncode != 0:
            err += f"nvcc failed with exit code {p.returncode}:\n{se}"
    if not err:
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + r.stdout + r.stderr)
        if r.returncode != 0:
            err = f"linking failed with exit code {r.returncode}:\n{r.stderr}"
    out.with_suffix(".log").write_text("".join(log))
    for o in objs:
        o.unlink(missing_ok=True)
    if err:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(err)
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
