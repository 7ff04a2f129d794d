"""The readings the limits of ``cells/<cell>.json`` are set from, on the
card at the cell's own size: the control (the plain reference in the
program's place, in float32, the precision below the configuration's
float64) or a fault of ``faults.py`` planted in the program, on several
seeds in one process, each a short window at the cell's own load.
The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--fault <name>]

One JSON line a seed: ``seed``, ``correct``, ``attempted`` and each
compared number beside its limit.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from portbench import harness

    kw = dict(fault=a.fault) if a.fault else dict(system="control")
    for seed in a.seeds:
        res, _ = harness.run(a.workload, seed, a.seconds, False, **kw)
        print(json.dumps(dict(seed=seed, what=a.fault or "control",
                              correct=res["correct"],
                              attempted=res["attempted"],
                              checks=res["checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
