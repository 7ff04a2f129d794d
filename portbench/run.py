"""The benchmark of heyoka_tpu_torch on one NVIDIA H100: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cells, metrics and bounds are in
``BENCHMARK.json``; ``harness.py`` says which files a cell is made of.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit; the same numbers are the last lines of standard error.
Without a CUDA device, or with fewer than the cell asks for, it prints
no result and exits with 2; if JAX or the JAX package is loaded once the
window has closed, with 3.

Caches stay inside the checkout: the kernel library in
``build/heyoka_tpu_torch`` (the port's default), and any torch extension
or Triton cache in ``build/portbench``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench"
                                         / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def _strict(x):
    """``x`` with every non-finite float as its name, so that the line is
    strict JSON even where a compared number is NaN."""
    if isinstance(x, dict):
        return {k: _strict(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_strict(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from portbench import harness

    chips = harness.Cell(a.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} device(s)", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result, rec = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                              t_process=T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print("setup " + " ".join(f"{k} {v!r}" for k, v in
                              rec["setup_parts"].items())
          + f" check_s {rec['check_s']!r}", file=sys.stderr)
    if "call_s" in rec:
        print("calls_s " + " ".join(f"{x:.4f}" for x in rec["call_s"]),
              file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(_strict(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
