"""``host_syncs_per_call.batch``: the program's host syncs (``hy.sync.*``
spans: reads from the device to the host, the loop's reads of the states
and times included) over its ``propagate_until`` calls
(``hy.propagate_until`` spans), in the traced window."""

from portbench import spans as sp


def read(rec, spans=None):
    w = sp.in_window(rec, spans)
    return sp.per(sp.syncs(w), w, "hy.propagate_until")
