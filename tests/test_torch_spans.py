"""The port's spans and host-sync counters (``heyoka_tpu_torch.logging``)
on the CPU: off, a span is one shared no-op and the log stays as it was;
under ``torch.profiler`` or with the logger at TRACE, the integrators'
calls record their trees of ``hy.*`` spans (the fused driver's chunks,
the landing and its steps, the results, ``step()``, the event step and
its isolation, the reads from the device), which land in the profiler's
events too; and the benchmark's six readers of those spans
(``portbench/metrics``) on synthetic logs."""

import logging as std_logging
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import heyoka_tpu_torch as ht
from heyoka_tpu_torch import logging as hlog
from heyoka_tpu_torch.taylor import batch as tbatch
from heyoka_tpu_torch.taylor import fused as tfused
from portbench import harness

MASSES = [1.0, 1e-3, 2e-3]
BASE = np.array([0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0,
                 0, 1.5, 0, -0.8, 0, 0], float)
HH = np.array([0.0, 0.1, 0.35, 0.1])
METRICS = Path(harness.__file__).resolve().parent / "metrics"


def nbody_batch(lanes=4):
    rng = np.random.default_rng(0)
    st = BASE[None] + 0.01 * rng.standard_normal((lanes, 18))
    return ht.taylor_adaptive_batch(ht.models.nbody(3, masses=MASSES), st,
                                    tol=1e-12, device="cpu")


def nbody_scalar():
    return ht.taylor_adaptive(ht.models.nbody(3, masses=MASSES), BASE,
                              tol=1e-12, device="cpu")


def hh_sys():
    x, y, px, py = ht.make_vars("x", "y", "px", "py")
    return [(x, px), (y, py), (px, -x - 2.0 * x * y),
            (py, y * y - x * x - y)], y


def hh_batch(nt_events=()):
    rng = np.random.default_rng(1)
    ics = HH[None] + 1e-3 * rng.standard_normal((6, 4))
    return ht.taylor_adaptive_batch(hh_sys()[0], ics, tol=1e-12,
                                    device="cpu", nt_events=nt_events)


def recorded(run):
    """The spans ``run()`` records under a CPU profiler, and the
    profiler."""
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return [s for s in hlog.spans() if s.t0_ns >= t0], prof


def children(spans, parent):
    return [s for s in spans if s.parent == parent.index]


@pytest.fixture
def quiet_trace():
    """The logger at TRACE with its handlers held at WARNING, restored
    afterwards."""
    lg = hlog.logger
    levels = [(x, x.level) for x in (lg, *lg.handlers)]
    hlog.set_logger_level_trace()
    for h in lg.handlers:
        h.setLevel(std_logging.WARNING)
    yield
    for x, level in levels:
        x.setLevel(level)


# -- off --------------------------------------------------------------------

OFF_RUNS = {
    "batch_propagate": lambda: nbody_batch().propagate_until(1.0),
    "batch_step": lambda: nbody_batch().step(),
    "scalar_step": lambda: (lambda ta: (ta.step(), ta.state, ta.time))(
        nbody_scalar()),
    "scalar_propagate": lambda: nbody_scalar().propagate_until(1.0),
}


@pytest.mark.parametrize("run", sorted(OFF_RUNS))
def test_off_records_nothing(run):
    old = hlog.logger.level
    hlog.set_logger_level_warn()
    try:
        off(run)
    finally:
        hlog.logger.setLevel(old)


def off(run):
    assert not hlog.logger.isEnabledFor(hlog.TRACE)
    assert not torch._C._autograd._profiler_enabled()
    a, b = hlog.trace_ctx("hy.a"), hlog.trace_ctx("hy.b")
    assert a is b
    with a as r:
        assert r is None
    before = hlog.spans()
    OFF_RUNS[run]()
    after = hlog.spans()
    assert len(after) == len(before)
    assert [s.index for s in after[-3:]] == [s.index for s in before[-3:]]


# -- under the profiler -------------------------------------------------------

@pytest.mark.parametrize("make,t", [(nbody_batch, 3.0), (hh_batch, 20.0)])
def test_propagate_until_records_its_tree(make, t):
    tb = make()
    spans, _ = recorded(lambda: tb.propagate_until(t))
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["hy.propagate_until"]
    root = roots[0]
    assert {s.call for s in spans} == {root.call}
    by_index = {s.index: s for s in spans}
    for s in spans[1:]:
        p = by_index[s.parent]
        assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    top = Counter(s.name for s in children(spans, root))
    # the direction is read only for non-terminal events' callbacks
    assert top["hy.sync.time"] == 0 and top["hy.landing"] == 1
    assert top["hy.finish"] == 1 and top["hy.fused.chunk"] >= 1
    # the first go flag alone, then one in each chunk
    assert top["hy.sync.fused_go"] == 1
    for c in [s for s in spans if s.name == "hy.fused.chunk"]:
        assert [k.name for k in children(spans, c)] == ["hy.sync.fused_go"]
    landing = next(s for s in spans if s.name == "hy.landing")
    steps = [s for s in children(spans, landing)
             if s.name == "hy.landing.step"]
    assert steps and all([k.name for k in children(spans, s)]
                         == ["hy.sync.pu_done"] for s in steps)
    finish = next(s for s in spans if s.name == "hy.finish")
    # one packed read; the per-lane lists wait for a reader
    assert [k.name for k in children(spans, finish)] == ["hy.sync.finish"]
    assert not [s for s in spans if s.name == "hy.finish.lists"]
    later, _ = recorded(lambda: (tb.get_propagate_res(),
                                 tb.get_propagate_res()))
    assert [s.name for s in later] == ["hy.finish.lists"]
    assert later[0].parent == -1


@pytest.mark.parametrize("chunk_steps", [2, 8, 64])
def test_chunk_spans_count_the_launches(monkeypatch, chunk_steps):
    monkeypatch.setattr(tbatch, "CHUNK_STEPS", chunk_steps)
    tb = nbody_batch()
    launches = []
    real = tfused.prop
    monkeypatch.setattr(tfused, "prop",
                        lambda *a: launches.append(1) or real(*a))
    spans, _ = recorded(lambda: tb.propagate_until(4.0))
    chunks = [s for s in spans if s.name == "hy.fused.chunk"]
    assert len(chunks) == len(launches) >= 1
    goes = [s for s in spans if s.name == "hy.sync.fused_go"]
    assert len(goes) == len(chunks) + 1
    if chunk_steps == 2:
        assert len(chunks) > 2


@pytest.mark.parametrize("scalar", [False, True])
def test_spans_are_profiler_events(scalar):
    if scalar:
        ta = nbody_scalar()
        spans, prof = recorded(lambda: (ta.step(), ta.propagate_until(2.0)))
    else:
        tb = nbody_batch()
        spans, prof = recorded(lambda: (tb.step(), tb.propagate_until(2.0)))
    events = Counter(e.name for e in prof.events()
                     if e.name.startswith("hy."))
    assert events == Counter(s.name for s in spans)
    assert {"hy.step", "hy.propagate_until", "hy.fused.chunk",
            "hy.sync.step"} <= set(events)


@pytest.mark.parametrize("scalar", [False, True])
def test_step_records_one_span_and_its_syncs(scalar):
    integ = nbody_scalar() if scalar else nbody_batch()
    spans, _ = recorded(lambda: (integ.step(), integ.state, integ.time))
    steps = [s for s in spans if s.name == "hy.step"]
    assert len(steps) == 1 and steps[0].parent == -1
    assert [k.name for k in children(spans, steps[0])] == \
        ["hy.sync.step"] * 3
    reads = Counter(s.name for s in spans if s.parent == -1)
    # the scalar's time is its (hi, lo) pair: two reads
    want = {"hy.step": 1, "hy.sync.state": 1}
    want.update({"hy.sync.dtime": 2} if scalar else {"hy.sync.time": 1})
    assert reads == want
    assert len({s.call for s in spans}) == len(spans) - 3


def test_calls_open_call_ids():
    tb = nbody_batch()
    spans, _ = recorded(lambda: (tb.propagate_until(1.0),
                                 tb.propagate_until(2.0)))
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["hy.propagate_until"] * 2
    assert roots[0].call != roots[1].call
    for r in roots:
        n = sum(s.call == r.call for s in spans)
        assert n > 5


def test_event_run_records_steps_and_isolations():
    y = hh_sys()[1]
    tb = hh_batch([ht.nt_event(y, lambda *a: None,
                               direction=ht.EventDirection.positive)])
    stats = tb._ev.find_roots_b.stats
    calls0 = stats["calls"]
    spans, _ = recorded(lambda: tb.propagate_until(10.0))
    grew = stats["calls"] - calls0
    steps = [s for s in spans if s.name == "hy.events.step"]
    iso = [s for s in spans if s.name == "hy.events.isolate"]
    assert grew > 0 and len(iso) == grew == len(steps)
    by_index = {s.index: s for s in spans}
    assert all(by_index[s.parent].name == "hy.events.step" for s in iso)
    assert all(by_index[s.parent].name == "hy.pu.step" for s in steps)
    roots = [s for s in spans if s.name == "hy.sync.roots"]
    assert roots and all(by_index[s.parent].name == "hy.events.isolate"
                         for s in roots)


# -- the logger at TRACE --------------------------------------------------------

@pytest.mark.parametrize("kind", ["trace_ctx", "host_read"])
def test_trace_level_alone_turns_the_log_on(quiet_trace, caplog, kind):
    assert not torch._C._autograd._profiler_enabled()
    t0 = time.perf_counter_ns()
    with caplog.at_level(hlog.TRACE, logger="heyoka_tpu_torch"):
        if kind == "trace_ctx":
            with hlog.trace_ctx("hy.unit") as r:
                assert r is None
        else:
            assert hlog.host_read("hy.unit", lambda: 7) == 7
    new = [s for s in hlog.spans() if s.t0_ns >= t0]
    assert [s.name for s in new] == ["hy.unit"]
    assert new[0].t1_ns >= new[0].t0_ns and new[0].parent == -1
    assert any(r.levelno == hlog.TRACE and r.getMessage().startswith(
        "hy.unit: ") for r in caplog.records)


def test_trace_level_records_a_propagation(quiet_trace):
    tb = nbody_batch()
    t0 = time.perf_counter_ns()
    tb.propagate_until(2.0)
    names = {s.name for s in hlog.spans() if s.t0_ns >= t0}
    assert {"hy.propagate_until", "hy.fused.chunk", "hy.landing",
            "hy.finish", "hy.sync.fused_go"} <= names


def test_the_log_is_bounded(quiet_trace, monkeypatch):
    # the TRACE lines kept from pytest's capture, which would hold them all
    monkeypatch.setattr(hlog.logger, "propagate", False)
    n = hlog.SPANS_KEPT + 25
    for _ in range(n):
        with hlog.trace_ctx("hy.fill"):
            pass
    kept = hlog.spans()
    assert len(kept) == hlog.SPANS_KEPT
    assert all(s.name == "hy.fill" for s in kept)
    idx = [s.index for s in kept]
    assert idx == list(range(idx[0], idx[0] + hlog.SPANS_KEPT))


# -- the benchmark's readers ------------------------------------------------------

def reader(name):
    return harness.load_module(METRICS / f"{name}.py",
                               f"portbench_metrics_{name}")


def S(index, name, t0, t1, parent=-1, call=1):
    return hlog.Span(index, name, t0, t1, parent, call)


#: a window of [1000, 2000] ns
REC = dict(t_begin=1e-6, window_s=1e-6)

#: two calls inside the window, one before and one it cuts
BATCH = [
    S(0, "hy.propagate_until", 500, 900, call=1),
    S(1, "hy.fused.chunk", 600, 800, 0, 1),
    S(2, "hy.propagate_until", 1000, 1400, call=2),
    S(3, "hy.sync.time", 1010, 1020, 2, 2),
    S(4, "hy.sync.fused_go", 1020, 1030, 2, 2),
    S(5, "hy.fused.chunk", 1030, 1200, 2, 2),
    S(6, "hy.sync.fused_go", 1180, 1200, 5, 2),
    S(7, "hy.landing", 1200, 1300, 2, 2),
    S(8, "hy.finish", 1300, 1400, 2, 2),
    S(9, "hy.sync.finish", 1310, 1340, 8, 2),
    S(10, "hy.propagate_until", 1500, 1800, call=3),
    S(11, "hy.fused.chunk", 1500, 1550, 10, 3),
    S(12, "hy.fused.chunk", 1550, 1600, 10, 3),
    S(13, "hy.landing", 1600, 1650, 10, 3),
    S(14, "hy.finish", 1700, 1800, 10, 3),
    S(15, "hy.sync.state", 1800, 1810, call=4),
    S(16, "hy.propagate_until", 1900, 2100, call=5),
    S(17, "hy.fused.chunk", 1900, 2050, 16, 5),
]

#: three steps inside the window, one it cuts
LANE = [
    S(0, "hy.step", 800, 1100, call=1),
    S(1, "hy.step", 1100, 1200, call=2),
    S(2, "hy.sync.step", 1150, 1170, 1, 2),
    S(3, "hy.sync.state", 1200, 1210, call=3),
    S(4, "hy.step", 1300, 1450, call=4),
    S(5, "hy.sync.step", 1310, 1320, 4, 4),
    S(6, "hy.sync.step", 1400, 1410, 4, 4),
    S(7, "hy.step", 1500, 1600, call=5),
    S(8, "hy.step", 1950, 2050, call=6),
]

READINGS = {
    # syncs 3, 4, 6, 9, 15 over calls 2 and 10
    "host_syncs_per_call.batch": (BATCH, 5 / 2),
    # chunks 5, 11, 12 over the same calls
    "chunks_per_call.batch": (BATCH, 3 / 2),
    # landings 100 + 50 ns over calls 400 + 300 ns
    "landing_share.batch": (BATCH, 150 / 700),
    # finish 100 - 30 (its sync) + 100 ns, over two calls, in ms
    "finish_ms_per_call.batch": (BATCH, 170 / 2 / 1e6),
    # syncs 2, 3, 5, 6 over steps 1, 4, 7
    "host_syncs_per_step.lane1": (LANE, 4 / 3),
    # steps 100 - 20, 150 - 20, 100 ns: the median 100 ns, in ms
    "step_host_ms.lane1": (LANE, 100 / 1e6),
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_on_a_window_that_cuts_spans(name):
    spans, want = READINGS[name]
    assert reader(name).read(REC, spans) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_without_spans_gives_none(name):
    r = reader(name)
    assert r.read(REC, []) is None
    # the window holds none of the log's spans
    assert r.read(dict(t_begin=1e-6, window_s=0.0)) is None
    # spans outside the window only
    spans, _ = READINGS[name]
    assert r.read(dict(t_begin=3e-6, window_s=1e-6), spans) is None


@pytest.mark.parametrize("name,parent", [("finish_ms_per_call.batch",
                                          "hy.finish"),
                                         ("step_host_ms.lane1", "hy.step")])
def test_self_time_leaves_out_the_syncs(name, parent):
    """Only the span's own ``hy.sync.*`` children are taken off: a sync
    elsewhere, or a child of another name, is not."""
    spans = [
        S(0, "hy.propagate_until", 1000, 1900, call=1),
        S(1, parent, 1000, 1500, call=1),
        S(2, "hy.sync.finish", 1100, 1300, 1, 1),
        S(3, "hy.sync.step", 1300, 1400, 1, 1),
        S(4, "hy.landing", 1400, 1450, 1, 1),
        S(5, "hy.sync.time", 1500, 1900, 0, 1),
    ]
    assert reader(name).read(REC, spans) == pytest.approx(200 / 1e6,
                                                          rel=1e-12)
