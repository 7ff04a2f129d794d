"""``taylor_roofline``: the least time the traced window's Taylor work
could take on the card, over the device's busy time in that window, in
percent.  The work is counted by the benchmark from the configuration's
equations and order (``reference/<config>.py`` ``flops_per_step``) times
the lane-steps the window took, and the bytes as each lane's state read
and written once a call; ``yardstick.least_seconds`` holds the peaks.
Nothing is read from the program's tapes or kernels, so the count is the
same whatever computes the jets."""

from portbench import yardstick


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["busy_s"] or not rec.get("lane_steps"):
        return None
    least = yardstick.least_seconds(rec["lane_steps"] * rec["flops_per_step"],
                                    rec["state_bytes"])
    return 100.0 * least / tr["busy_s"]
