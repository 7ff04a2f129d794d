"""``device_idle_share.batch``: 1 - the device's busy time over the
traced window's time (``torch.profiler``), on the batch cells."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["busy_s"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
