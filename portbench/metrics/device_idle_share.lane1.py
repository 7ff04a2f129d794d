"""``device_idle_share.lane1``: 1 - the device's busy time over the
traced window's time (``torch.profiler``), on the one-lane step cell."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["busy_s"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
