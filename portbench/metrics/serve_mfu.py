"""serve_mfu: the served forward's model FLOPs a call (backbone, FPN, the
head's prob branch: what the prob-only forward needs) times the calls of
the untraced window, over its time, against one H100's dense bfloat16 peak
(989 TFLOP/s; the result line gives the card's power limit). FLOPs are
``reference.flops.forward_flops(prob_only=True)``: 2 · conv and deconv
MACs."""

PEAK_FLOPS = 989e12


def read(view):
    info = view.info
    if info["traffic"]["kind"] != "serve" or not info["window_s"]:
        return None
    rate = info["unit_flops"] * info["window_units"] / info["window_s"]
    return 100.0 * rate / PEAK_FLOPS
