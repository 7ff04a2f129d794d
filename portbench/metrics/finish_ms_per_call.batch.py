"""``finish_ms_per_call.batch``: the time of taking a call's results to
the host (``hy.finish`` spans: per-lane Python lists over the batch) less
its own host syncs, which wait for the device, summed over the traced
window and over its ``propagate_until`` calls, in ms: serial host time,
with no device work queued behind it."""

from portbench import spans as sp


def read(rec, spans=None):
    w = sp.in_window(rec, spans)
    n = len(sp.named(w, "hy.propagate_until"))
    if not n:
        return None
    return sum(sp.self_ns(w, "hy.finish")) / n / 1e6
