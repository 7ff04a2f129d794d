"""Logging / tracing subsystem, copied from ``heyoka_tpu.logging``.

Reference parity: heyoka's spdlog-based logger with runtime level control
(``src/logging.cpp:22-42``) and the ``simple_timer`` RAII profiler
(``include/heyoka/detail/simple_timer.hpp``).  Here: a std-logging logger
named "heyoka_tpu_torch" with the same level-setting API, a scope timer
usable as a context manager, and a hook into ``torch.profiler`` traces for
device-side profiling (where the JAX package annotates ``jax.profiler``
traces).
"""

from __future__ import annotations

import contextlib
import logging as _logging
import time as _time

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


@contextlib.contextmanager
def trace_ctx(name: str):
    """Annotate a region in both the host log and a ``torch.profiler``
    trace (a ``record_function`` range)."""
    from torch.profiler import record_function

    with SimpleTimer(name), record_function(name):
        yield
