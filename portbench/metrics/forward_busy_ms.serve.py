"""forward_busy_ms.serve: the device time a call of everything but the
rect postprocess's kernels (the names ``cc_device_ms.serve`` lists) and
the copies between host and device: the folded forward's kernels, with
the means' subtraction and the fills."""

import runpy
from pathlib import Path

IS_CC = runpy.run_path(str(Path(__file__).with_name(
    "cc_device_ms.serve.py")))["is_cc"]


def read(view):
    if view.info["traffic"]["kind"] != "serve" or not view.units:
        return None
    us = view.op_us(lambda n: not IS_CC(n) and "Memcpy" not in n)
    return us / 1e3 / view.units
