"""``kernels_per_step.lane1``: the device kernels of the traced window
(``torch.profiler``; copies and sets left out) over its ``step()``
calls."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not rec.get("step_ms") or not tr["kernels"]:
        return None
    return tr["kernels"] / len(rec["step_ms"])
