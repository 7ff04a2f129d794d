"""One run of one cell: the cell's files found by the names in
``BENCHMARK.json``, set-up, the window, the check, the result.

A cell (``workloads`` entry) names a configuration and a traffic mix.
The harness reads

- ``configs/<config>.json`` (the ``file``: sizes, initial state,
  tolerance) and ``configs/<config>.py`` (the equations as the program
  is given them);
- ``reference/<config>.py`` (the plain reference, its energy and its
  work count);
- ``traffic/<traffic>.json``: the ``loop`` and its parameters, and the
  ``integrator`` options the program is built with beside the
  configuration's tolerance;
- ``loops/<loop>.py``: the program under test (``Port``) and the
  reference in its place (``Control``), the run loop (``run``), the
  numbers the check compares (``numbers``) and the faults the loop can
  have (``FAULTS``): those of ``faults.py``, and any of its own, which
  its ``plant(name)`` plants (see :func:`plant_fault`);
- ``cells/<cell>.json`` (the limits of the numbers compared, with the
  readings they were set from);
- ``metrics/<metric>.py`` for each metric the cell reports: the
  end-to-end ones with ``--trace 0``, the per-layer ones with
  ``--trace 1``.

The benchmark's CPU tests drive each cell at the size of
``tiny/<cell>.json``, entries that replace the traffic's.

So a new cell, configuration, kind of traffic, loop or metric is new
files and entries, and no file here changes.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from . import check, faults, trace, yardstick
from .reference import taylor

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "heyoka_tpu")


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell's entries in ``BENCHMARK.json`` and the files they name."""

    def __init__(self, name):
        m = read_json(ROOT / "BENCHMARK.json")
        wl = {w["name"]: w for w in m["workloads"]}
        if name not in wl:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.workload = name, wl[name]
        entry = {c["name"]: c for c in m["configs"]}[self.workload["config"]]
        self.cfg = read_json(ROOT / entry["file"])
        self.traffic = read_json(BENCH / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = read_json(BENCH / "cells" / f"{name}.json")["limits"]
        self.port_system = self._module("configs", self.cfg["name"])
        self.ref = self._module("reference", self.cfg["name"])
        self.loop = self._module("loops", self.traffic["loop"])
        self.end_to_end = [x for x in m["end_to_end"] if self._mine(x)]
        self.per_layer = [x for x in m["per_layer"] if self._mine(x)]

    @staticmethod
    def _module(kind, name):
        return load_module(BENCH / kind / f"{name}.py",
                           f"portbench_{kind}_{name}")

    def _mine(self, metric):
        return self.name in metric.get("workloads", [self.name])

    def reader(self, metric):
        return self._module("metrics", metric)

    def integrator_options(self):
        """The program's keyword arguments: the configuration's tolerance
        and ``high_accuracy``, and the traffic's ``integrator`` options."""
        return dict(tol=self.cfg["tol"],
                    high_accuracy=self.cfg["high_accuracy"],
                    **self.traffic.get("integrator", {}))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def plant_fault(loop, name):
    """The wrapper that plants the fault ``name``, one of the loop
    module's ``FAULTS``, into a system of that loop: the loop's own, where
    its ``plant(name)`` gives one, else that of ``faults.py``, which
    raises on a name it does not know."""
    if name not in loop.FAULTS:
        raise ValueError(f"the loop has no fault {name!r}; its FAULTS are "
                         f"{loop.FAULTS}")
    own = getattr(loop, "plant", None)
    return (own and own(name)) or faults.plant(name)


def _systems(cell, ics, device, system, fault):
    """The system a run drives: the program (``"port"``) or the reference
    in float32 in its place (``"control"``), with ``fault`` planted."""
    if system == "port":
        import heyoka_tpu_torch as ht

        s = cell.loop.Port(ht, cell, ics, device)
    elif system == "control":
        s = cell.loop.Control(cell, ics, device, torch.float32)
    else:
        raise ValueError(f"unknown system {system!r}")
    return plant_fault(cell.loop, fault)(s) if fault else s


@contextlib.contextmanager
def _traced_window(device):
    """The window's span in a traced run."""
    with torch.profiler.record_function(trace.WINDOW):
        yield
        _sync(device)


def run(name, seed, seconds, traced, *, t_process=None, device="cuda",
        system="port", fault=None, overrides=None):
    """One run of the cell ``name``; returns ``(result, rec)``: the
    result line's object (``checks`` its last key) and the run's record
    (what the check and the metric readers read).  ``t_process``: the
    process's start on ``time.perf_counter`` (the start of set-up).
    ``overrides`` replaces entries of the traffic (tests run tiny cells
    with it)."""
    t_process = time.perf_counter() if t_process is None else t_process
    cell = Cell(name)
    cell.traffic = {**cell.traffic, **(overrides or {})}
    tr = cell.traffic
    ics = yardstick.initial_conditions(cell.cfg, tr["lanes"], seed)
    t_build = time.perf_counter()
    s = _systems(cell, ics, device, system, fault)
    t_built = time.perf_counter()

    def window():
        return _traced_window(device) if traced else contextlib.nullcontext()

    # the profiler runs from before set-up's call, so that its own start,
    # seconds in a fresh process, stays out of the window
    prof = trace.profiler() if traced else contextlib.nullcontext()
    with prof:
        rec = cell.loop.run(s, cell, ics, seed, seconds, window)
    rec.update(seed=seed, setup_s=rec["t_begin"] - t_process,
               setup_parts=dict(before_build=t_build - t_process,
                                build=t_built - t_build,
                                warmup=rec["t_begin"] - t_built),
               flops_per_step=cell.ref.flops_per_step(
                   cell.cfg, taylor.order_from_tol(cell.cfg["tol"])))
    is_cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
    if traced:
        rec["trace"] = trace.reduce(prof)
    del s, prof
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = cell.loop.numbers(rec, cell, device)
    rec["check_s"] = time.perf_counter() - t_check
    correct, checks = check.judge(numbers, cell.limits)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = cell.reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = dict(platform="gpu" if is_cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if is_cuda
               else "cpu", count=1, memory_peak_bytes=peak)
    result = dict(correct=correct, attempted=rec["attempted"],
                  failed=rec["failed"], metrics=metrics, device=dev)
    if traced:
        dev.update(busy_s=rec["trace"]["busy_s"],
                   window_s=rec["trace"]["window_s"])
        result["breakdown"] = {k: rec["trace"][k]
                               for k in ("device_ops", "idle_gaps")}
    result["checks"] = checks
    return result, rec


def forbidden_modules():
    """The modules of ``FORBIDDEN`` this process holds, by whole
    top-level name."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
