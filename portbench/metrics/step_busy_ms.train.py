"""step_busy_ms.train: the device's busy time a training step, the union
of the intervals of every device operation (kernels, copies, fills) over
the profiled steps, divided by their count."""


def read(view):
    if view.info["traffic"]["kind"] != "train" or not view.units:
        return None
    return view.busy_us / 1e3 / view.units
