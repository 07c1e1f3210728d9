"""d1_roofline.train: D1 (``csrc/deform.cu``), the deformable convs'
sampling, against its bound over a training step. A conv of input N × C ×
H × W at stride s (output OH × OW) must move, forward
(``deform_im2col``), the float32 input read once, the float32 offsets
(N · OH · OW · 18) read and the columns (9 · N · OH · OW · C, in the
compute dtype, 2 bytes in bfloat16) written; backward
(``deform_col2im``), the columns' gradient read, the input and offsets read
and their gradients written. The bound is those bytes over every
deformable conv of the step at 3.35 TB/s; the time is the two kernels'
device time a step. None where neither kernel ran."""

from portbench.reference import flops

HBM_BYTES_PER_S = 3.35e12
KERNELS = ("deform_im2col", "deform_col2im")
COL_BYTES = {"bfloat16": 2, "float32": 4}


def conv_bytes(n: int, c: int, h: int, w: int, s: int, col: int) -> int:
    """The bytes one deformable conv's forward and backward must move."""
    oh, ow = (h - 1) // s + 1, (w - 1) // s + 1
    x_b, off_b = n * c * h * w * 4, n * oh * ow * 18 * 4
    cols_b = 9 * n * oh * ow * c * col
    return (x_b + off_b + cols_b) + (cols_b + 2 * (x_b + off_b))


def step_bytes(cfg: dict, batch: int, size: int) -> int:
    col = COL_BYTES[cfg["train_dtype"]]
    return sum(conv_bytes(*shape, s, col) for shape, s in
               flops.count(cfg, batch, size, train=True).deform_shapes)


def read(view):
    t, cfg = view.info["traffic"], view.info["config"]
    if t["kind"] != "train" or not view.units:
        return None
    us = view.op_us(lambda n: any(k in n for k in KERNELS))
    if not us:
        return None
    bound_s = step_bytes(cfg, t["batch"], t["image_size"]) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (us / 1e6 / view.units)
