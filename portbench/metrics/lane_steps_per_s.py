"""``lane_steps_per_s``: every lane-step of every ``propagate_until`` call
the window completed, over the window's whole time (host clock, each
call ending with its states on the host)."""


def read(rec):
    if "lane_steps" not in rec:
        return None
    return rec["lane_steps"] / rec["window_s"]
