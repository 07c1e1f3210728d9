"""idle_share.serve: the share of the profiled calls' wall time in which
no device operation ran: 1 − (the union of the device operations'
intervals) / (the host clock around the calls, which end in a
synchronisation), from the trace's first pass, which records the device
alone and so slows the host little."""


def read(view):
    if view.info["traffic"]["kind"] != "serve" or not view.window_us:
        return None
    return 100.0 * (1.0 - view.busy_us / view.window_us)
