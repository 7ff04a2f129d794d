"""``step_host_ms.lane1``: the median over the traced window's ``step()``
calls (``hy.step`` spans) of a call's time less its own host syncs
(``hy.sync.*`` children), in ms: the host's own time a step."""

import statistics

from portbench import spans as sp


def read(rec, spans=None):
    ns = sp.self_ns(sp.in_window(rec, spans), "hy.step")
    return statistics.median(ns) / 1e6 if ns else None
