"""The harness's promise that a cell, with a traffic mix and a loop of
its own, is new files and entries alone.  In a copy of the benchmark
(``BENCHMARK.json`` and ``portbench/``) a cell is added so: a traffic
file and its workload entry, the cell's limits, its tiny size, its name
in the metrics' ``workloads`` lists, and a loop file that wraps the
``propagate`` loop and plants one fault of its own.  Then the copy's own
tests run there: every one passes, the new cell's among them (its own
fault not ``correct``), and no file that was there before has changed."""

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

from portbench import harness

#: the name of what the test adds
NEW = "added"
#: the new loop: ``propagate`` with a fault that no other loop has
LOOP = '''"""The ``propagate`` loop with a fault of its own, ``lanes_rolled``:
each lane's state comes back as its neighbour's."""

import numpy as np

from portbench import harness

_base = harness.load_module(harness.BENCH / "loops" / "propagate.py",
                            "portbench_loops_propagate_of_added")
Port, Control, run, numbers = (_base.Port, _base.Control, _base.run,
                               _base.numbers)
FAULTS = _base.FAULTS + ("lanes_rolled",)


class _Rolled:
    def __init__(self, inner):
        self.inner = inner

    def call(self, t):
        r = dict(self.inner.call(t))
        r["state"] = np.roll(r["state"], 1, axis=0)
        return r


def plant(name):
    return _Rolled if name == "lanes_rolled" else None
'''


def digests(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def add_cell(root):
    """Adds the cell ``<config>.added`` to the benchmark at ``root``, on
    the configuration of the ``propagate`` cell with the fewest
    variables, by new files and entries alone; returns its name."""
    bench = root / "portbench"
    m = json.loads((root / "BENCHMARK.json").read_text())
    cfgs = {c["name"]: json.loads((root / c["file"]).read_text())
            for c in m["configs"]}

    def traffic(w):
        return json.loads((bench / "traffic" / f"{w['traffic']}.json")
                          .read_text())

    base = min((w for w in m["workloads"]
                if traffic(w)["loop"] == "propagate"),
               key=lambda w: len(cfgs[w["config"]]["ic"]))
    name = f"{base['config']}.{NEW}"
    files = {
        f"traffic/{NEW}.json": {**traffic(base), "loop": NEW,
                                "span": traffic(base)["span"] + 10.0},
        f"cells/{name}.json": json.loads(
            (bench / "cells" / f"{base['name']}.json").read_text()),
        f"tiny/{name}.json": (lambda t: {**t, "span": t["span"] + 1.0})(
            json.loads((bench / "tiny" / f"{base['name']}.json")
                       .read_text())),
    }
    for rel, obj in files.items():
        (bench / rel).write_text(json.dumps(obj, indent=1) + "\n")
    (bench / "loops" / f"{NEW}.py").write_text(LOOP)
    m["workloads"].append(dict(
        name=name, config=base["config"], traffic=NEW, chips=1,
        why="a cell added by new files and entries alone, with a loop "
            "and a fault of its own"))
    for metric in m["end_to_end"] + m["per_layer"]:
        if base["name"] in metric.get("workloads", []):
            metric["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(m, indent=1) + "\n")
    return name


def test_a_cell_is_new_files_and_entries(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    before = digests(tmp_path)
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    name = add_cell(tmp_path)

    junit = tmp_path / "junit.xml"
    # the copy's portbench first, then the program where this one finds it
    program = Path(importlib.util.find_spec("heyoka_tpu_torch").origin)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(program.parent.parent)]))
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "portbench/tests", "-q",
         "-p", "no:cacheprovider", f"--ignore=portbench/tests/"
         f"{Path(__file__).name}", f"--junitxml={junit}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stdout[-4000:]
    cases = {c.get("name"): c for c in ET.parse(junit).iter("testcase")}
    fault = f"test_fault_is_not_correct[{name}-lanes_rolled]"
    assert fault in cases and not list(cases[fault]), p.stdout[-4000:]
    for test in ("test_check_follows_the_seed", "test_control_is_not_correct",
                 "test_cell_files_found_by_name"):
        case = cases[f"{test}[{name}]"]
        assert not list(case), (test, p.stdout[-4000:])

    after = digests(tmp_path)
    changed = [f for f, h in before.items()
               if f != "BENCHMARK.json" and after.get(f) != h]
    assert not changed
    # BENCHMARK.json: the old entries as they were, the new name appended
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["workloads"] = [w for w in m["workloads"] if w["name"] != name]
    for metric in m["end_to_end"] + m["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = [w for w in metric["workloads"]
                                   if w != name]
    assert m == manifest
