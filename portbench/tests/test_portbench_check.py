"""Each cell driven end to end on the CPU at the tiny size of its
``tiny/<cell>.json`` (the program's plain torch twins in place of its
CUDA kernels): the program agrees with the reference and comes out
``correct``; the control, the reference in float32 in the program's
place, and every fault the cell's loop can have (``FAULTS``: those of
``faults.py`` and the loop's own), come out not correct; the result line
has the contract's keys, ``checks`` last.  On a card, one short run of
``run.py``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import faults, harness

ROOT = Path(harness.__file__).resolve().parent.parent
#: a seed past 32 signed bits, as the checks draw them
SEED = 2**31 + 977
#: each cell's traffic cut to a size a test run holds, a file a cell
TINY = harness.BENCH / "tiny"
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def tiny(name, **kw):
    return harness.run(name, SEED, 0.6, kw.pop("traced", False),
                       device="cpu",
                       overrides=harness.read_json(TINY / f"{name}.json"),
                       **kw)


def test_every_cell_has_a_tiny_size():
    assert sorted(p.stem for p in TINY.glob("*.json")) == sorted(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_check_follows_the_seed(name):
    """The compared answers begin with a chain from the seed's initial
    state and go on to the window's last."""
    res, rec = tiny(name)
    n = len(rec.get("calls", rec.get("steps", [])))
    assert n >= 3 and res["correct"], res["checks"]
    assert {"state_gap", "energy_drift"} <= set(res["checks"])


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name, traced):
    res, rec = tiny(name, traced=traced)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    cell = harness.Cell(name)
    want = cell.per_layer if traced else cell.end_to_end
    assert set(res["metrics"]) <= {m["name"] for m in want}
    if traced:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    else:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res, _ = tiny(name, system="control")
    assert not res["correct"], res["checks"]
    assert res["checks"]["state_gap"]["value"] > \
        res["checks"]["state_gap"]["limit"]


FAULT_CASES = [(name, f) for name in CELLS
               for f in harness.Cell(name).loop.FAULTS]


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_fault_is_not_correct(name, fault):
    res, _ = tiny(name, fault=fault)
    assert not res["correct"], (fault, res["checks"])


def test_an_unknown_fault_is_refused():
    """A name that neither the loop nor ``faults.py`` knows raises, and
    so does one of ``faults.py`` that the loop does not list: taken from
    the loop of the fewest faults, which leaves some of ``faults.py``
    out."""
    loop = min((harness.Cell(n).loop for n in CELLS),
               key=lambda lp: len(lp.FAULTS))
    unlisted = set(faults.NAMES) - set(loop.FAULTS)
    assert unlisted, loop.FAULTS
    with pytest.raises(ValueError, match="unknown fault"):
        faults.plant("no_such_fault")
    for name in ("no_such_fault", *sorted(unlisted)):
        with pytest.raises(ValueError, match="has no fault"):
            harness.plant_fault(loop, name)


def test_run_without_a_card_prints_nothing():
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT / "build" / "portbench")})
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert p.returncode == 2 and p.stdout == "", (p.returncode, p.stderr)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name,
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
