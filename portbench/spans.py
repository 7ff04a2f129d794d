"""The program's own spans in a run's window, for the per-layer metrics
that read them (``metrics/<name>.py``).

``heyoka_tpu_torch.logging.spans()`` holds the spans the program opened
while a profiler recorded (a ``--trace 1`` run), on
``time.perf_counter_ns``, the clock of the window's ``t_begin``.  Each has
``index``, ``name``, ``t0_ns``, ``t1_ns``, ``parent`` (the index of the
span around it, -1 at a call's root) and ``call``.  A ``hy.sync.<site>``
span is one read from the device to the host: its count is the count of
host syncs and its duration the host's wait.  Where the program keeps no
such log, or the run did not load it, there are no spans and every
reader gives None.
"""

import sys

SYNC = "hy.sync."


def in_window(rec, spans=None):
    """The spans (``spans``, else the program's log) that lie within the
    window ``[t_begin, t_begin + window_s]`` of the record ``rec``."""
    if spans is None:
        read = getattr(sys.modules.get("heyoka_tpu_torch.logging"), "spans",
                       None)
        if read is None:
            return []
        spans = read()
    a = rec["t_begin"] * 1e9
    b = a + rec["window_s"] * 1e9
    return [s for s in spans if s.t0_ns >= a and s.t1_ns <= b]


def named(spans, name):
    return [s for s in spans if s.name == name]


def syncs(spans):
    return [s for s in spans if s.name.startswith(SYNC)]


def per(picked, spans, over):
    """How many of ``picked`` there are for each span named ``over``;
    None without one."""
    n = len(named(spans, over))
    return len(picked) / n if n else None


def self_ns(spans, name):
    """Each span named ``name``: its time less that of its own host-sync
    spans (its children named ``hy.sync.*``), in ns."""
    waits = {}
    for s in syncs(spans):
        waits[s.parent] = waits.get(s.parent, 0) + s.t1_ns - s.t0_ns
    return [s.t1_ns - s.t0_ns - waits.get(s.index, 0)
            for s in named(spans, name)]
