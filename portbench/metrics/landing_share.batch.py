"""``landing_share.batch``: the per-step landing's time (``hy.landing``
spans, host clock) over the ``propagate_until`` calls' time
(``hy.propagate_until`` spans), in the traced window."""

from portbench import spans as sp


def read(rec, spans=None):
    w = sp.in_window(rec, spans)
    calls = sum(s.t1_ns - s.t0_ns for s in sp.named(w, "hy.propagate_until"))
    if not calls:
        return None
    return sum(s.t1_ns - s.t0_ns for s in sp.named(w, "hy.landing")) / calls
