"""k10_roofline.train: K10's select (``k10_select``, ``csrc/ohem.cu``,
OHEM's top-k sum over the loss map) against its bound: one read of the
N × H × W float32 loss map at 3.35 TB/s (one H100's HBM rate), over the
kernel's device time a call. None where the kernel did not run."""

HBM_BYTES_PER_S = 3.35e12
KERNEL = "k10_select"


def read(view):
    t = view.info["traffic"]
    if t["kind"] != "train":
        return None
    calls = view.op_count(lambda n: KERNEL in n)
    if not calls:
        return None
    per_call_s = view.op_us(lambda n: KERNEL in n) / 1e6 / calls
    bound_s = t["batch"] * t["image_size"] ** 2 * 4 / HBM_BYTES_PER_S
    return 100.0 * bound_s / per_call_s
