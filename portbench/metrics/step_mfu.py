"""``step_mfu``: the least time the traced window's Taylor work could
take on the card (counted as ``taylor_roofline`` counts it), over the
traced window's whole time, in percent: the whole step's share of the
card's peak, idle time included."""

from portbench import yardstick


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["busy_s"] or not rec.get("lane_steps"):
        return None
    least = yardstick.least_seconds(rec["lane_steps"] * rec["flops_per_step"],
                                    rec["state_bytes"])
    return 100.0 * least / tr["window_s"]
