"""train_mfu: the training step's model FLOPs over the untraced window's
time, against one H100's dense bfloat16 peak (989 TFLOP/s, NVIDIA's data
sheet, SXM, at the full 700 W; the run's result line gives the card's power
limit). The FLOPs of a step are ``reference.flops.train_step_flops``:
3 · 2 · the forward's conv and deconv MACs at the cell's batch and size."""

PEAK_FLOPS = 989e12


def read(view):
    info = view.info
    if info["traffic"]["kind"] != "train" or not info["window_s"]:
        return None
    rate = info["unit_flops"] * info["window_units"] / info["window_s"]
    return 100.0 * rate / PEAK_FLOPS
