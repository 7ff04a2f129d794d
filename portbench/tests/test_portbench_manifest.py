"""``BENCHMARK.json`` and the files its names lead to: the keys, names,
units and limits the benchmark's contract fixes, and every cell's
configuration, traffic, limits and metric readers found by name."""

import json
import math
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(harness.__file__).resolve().parent.parent
M = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in M["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"]
    assert M["command"] == ["python3", "portbench/run.py"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    s = M["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in M["configs"]] + CELLS + [
        m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank"))
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] == 1
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        # each listed cell reports the end-to-end metric this one moves
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m.get("workloads", moved)) <= set(moved)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.Cell(name)
    entry = {c["name"]: c for c in M["configs"]}[cell.workload["config"]]
    assert entry["file"].startswith("portbench/")
    assert cell.cfg["name"] == entry["name"]
    assert cell.cfg["source"] == entry["source"]
    assert cell.cfg["reduced"] == entry["reduced"]
    assert callable(cell.port_system.system)
    assert callable(cell.ref.make) and callable(cell.ref.flops_per_step)
    for part in ("Port", "Control", "run", "numbers"):
        assert callable(getattr(cell.loop, part)), part
    assert cell.loop.FAULTS
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    for k, v in cell.limits.items():
        assert NAME.match(k) and v >= 0 and math.isfinite(v)


def test_every_config_is_used_once_by_file():
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}


def test_integrator_options_come_from_the_files():
    cell = harness.Cell(CELLS[0])
    cell.traffic = {**cell.traffic, "integrator": {"backend": "native"}}
    assert cell.integrator_options() == dict(
        tol=cell.cfg["tol"], high_accuracy=cell.cfg["high_accuracy"],
        backend="native")
