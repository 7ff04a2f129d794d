"""Logging and tracing, after ``heyoka_tpu.logging``.

Reference parity: heyoka's spdlog-based logger with runtime level control
(``src/logging.cpp:22-42``) and the ``simple_timer`` RAII profiler
(``include/heyoka/detail/simple_timer.hpp``).  Here: a std-logging logger
named "heyoka_tpu_torch" with the same level-setting API, a scope timer
usable as a context manager, and :func:`trace_ctx`, the port's one span
API, which the integrators call at their layer boundaries.

A span is off (one shared no-op context) unless a ``torch.profiler``
session is recording or the logger is at ``TRACE``
(:func:`set_logger_level_trace`).  When on, it opens a
``record_function`` range (with a profiler recording: the span lands in
the trace on the profiler's clock, beside the device's activity), appends
a record to an in-memory log of the last :data:`SPANS_KEPT` spans,
on ``time.perf_counter_ns``, and at ``TRACE`` logs its time through
:class:`SimpleTimer`.  :func:`spans` reads the log.

The spans the port records (``hy.`` names): ``hy.propagate_until`` (a
batch's ``propagate_until``, scalar calls included), ``hy.fused.chunk``
(a launch of kernel B1 and the wait for it), ``hy.landing`` and
``hy.landing.step`` (the per-step landing after B1 and each of its
steps), ``hy.pu.step`` (a step of the per-step driver elsewhere),
``hy.finish`` (a propagation's result taken to the host),
``hy.finish.lists`` (a result's per-lane tuples, built at their first
read), ``hy.step`` (a public ``step()``), ``hy.events.step`` and
``hy.events.isolate`` (the event step and its root finding); and ``hy.sync.<site>``, one a read
from the device to the host (:func:`host_read`), whose duration is the
host's wait and whose count is the count of host syncs.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging as _logging
import threading
import time as _time

import torch

__all__ = [
    "logger",
    "set_logger_level_trace",
    "set_logger_level_debug",
    "set_logger_level_info",
    "set_logger_level_warn",
    "set_logger_level_err",
    "set_logger_level_critical",
    "SimpleTimer",
    "trace_ctx",
    "host_read",
    "spans",
    "Span",
    "SPANS_KEPT",
]

#: trace level below DEBUG, like spdlog's
TRACE = 5
_logging.addLevelName(TRACE, "TRACE")

logger = _logging.getLogger("heyoka_tpu_torch")
if not logger.handlers:
    _h = _logging.StreamHandler()
    _h.setFormatter(
        _logging.Formatter(
            "[%(asctime)s] [heyoka_tpu_torch] [%(levelname)s] %(message)s")
    )
    logger.addHandler(_h)
    logger.setLevel(_logging.WARNING)


def set_logger_level_trace():
    logger.setLevel(TRACE)


def set_logger_level_debug():
    logger.setLevel(_logging.DEBUG)


def set_logger_level_info():
    logger.setLevel(_logging.INFO)


def set_logger_level_warn():
    logger.setLevel(_logging.WARNING)


def set_logger_level_err():
    logger.setLevel(_logging.ERROR)


def set_logger_level_critical():
    logger.setLevel(_logging.CRITICAL)


class SimpleTimer:
    """Wall-clock scope timer (heyoka ``detail::simple_timer``): logs the
    elapsed time at TRACE level on exit.

    >>> with SimpleTimer("jet compilation"):
    ...     ...
    """

    def __init__(self, name: str = "timer"):
        self._name = name
        self.elapsed = None

    def __enter__(self):
        self._t0 = _time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = _time.perf_counter() - self._t0
        logger.log(TRACE, "%s: %.6f s", self._name, self.elapsed)
        return False


#: span records the log keeps; older ones are dropped
SPANS_KEPT = 1 << 17

#: a span's record: its index (the order of its start, over the process),
#: name, start and end on ``time.perf_counter_ns``, the index of the span
#: open around it (-1: none) and its call id (one per outermost span,
#: shared by the spans inside it)
Span = collections.namedtuple("Span", "index name t0_ns t1_ns parent call")

_log = collections.deque(maxlen=SPANS_KEPT)
_index = itertools.count()
_calls = itertools.count(1)
_open = threading.local()
_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Region:
    """An open span: a ``record_function`` range while a profiler records,
    a :class:`SimpleTimer` at ``TRACE``, and its record in the log,
    innermost."""

    __slots__ = ("_name", "_rec", "_rf", "_timer")

    def __init__(self, name):
        self._name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent, call = (stack[-1][0], stack[-1][5]) if stack \
            else (-1, next(_calls))
        self._rf = None
        if _profiling():
            from torch.profiler import record_function

            self._rf = record_function(self._name)
            self._rf.__enter__()
        self._timer = SimpleTimer(self._name).__enter__() \
            if logger.isEnabledFor(TRACE) else None
        rec = self._rec = [next(_index), self._name, 0, None, parent, call]
        stack.append(rec)
        _log.append(rec)
        rec[2] = _time.perf_counter_ns()

    def __exit__(self, *exc):
        self._rec[3] = _time.perf_counter_ns()
        _open.stack.pop()
        if self._timer is not None:
            self._timer.__exit__(*exc)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def trace_ctx(name: str):
    """The span ``name`` over a region (``with trace_ctx(name):``, which
    binds None): the shared no-op context unless a ``torch.profiler``
    session is recording or the logger is at ``TRACE``."""
    if _profiling() or logger.isEnabledFor(TRACE):
        return _Region(name)
    return _OFF


def host_read(name: str, read):
    """``read()``, a read from the device to the host (a tensor's
    ``tolist``, ``cpu``, ...), in the span ``name`` (``hy.sync.<site>``)
    where spans are on."""
    with trace_ctx(name):
        return read()


def spans() -> list:
    """The finished spans of the log (:class:`Span`), in the order they
    started: the last :data:`SPANS_KEPT` the process opened."""
    return [Span(*r) for r in list(_log) if r[3] is not None]
