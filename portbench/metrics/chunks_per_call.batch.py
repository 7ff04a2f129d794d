"""``chunks_per_call.batch``: the fused driver's chunks (``hy.fused.chunk``
spans, one a launch of kernel B1) over the ``propagate_until`` calls
(``hy.propagate_until`` spans), in the traced window."""

from portbench import spans as sp


def read(rec, spans=None):
    w = sp.in_window(rec, spans)
    return sp.per(sp.named(w, "hy.fused.chunk"), w, "hy.propagate_until")
