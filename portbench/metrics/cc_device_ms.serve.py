"""cc_device_ms.serve: the device time a call of the rect postprocess's
kernels (``csrc/cc.cu``: K3 labelling, K4 slots, K6 holes, K5 rects),
matched by the kernel names below."""

KERNELS = ("k3_local", "k3_merge", "k3_flatten", "k4_rank", "k4_assign",
           "k5_moments1", "k5_rows", "k5_moments2", "k5_search", "k6_scan",
           "k6_accumulate")


def is_cc(name: str) -> bool:
    return any(k in name for k in KERNELS)


def read(view):
    if view.info["traffic"]["kind"] != "serve" or not view.units:
        return None
    us = view.op_us(is_cc)
    if not us:
        return None
    return us / 1e3 / view.units
