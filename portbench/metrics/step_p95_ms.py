"""``step_p95_ms``: the 95th percentile of every ``step()`` call of the
window, each timed on the host clock until its state is on the host
(Python's ``statistics.quantiles`` with ``n=20``, exclusive method)."""

import statistics


def read(rec):
    ms = rec.get("step_ms")
    if not ms or len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[18]
