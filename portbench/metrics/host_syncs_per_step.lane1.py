"""``host_syncs_per_step.lane1``: the program's host syncs (``hy.sync.*``
spans: reads from the device to the host, the loop's reads of the state
and time included) over its ``step()`` calls (``hy.step`` spans), in the
traced window."""

from portbench import spans as sp


def read(rec, spans=None):
    w = sp.in_window(rec, spans)
    return sp.per(sp.syncs(w), w, "hy.step")
