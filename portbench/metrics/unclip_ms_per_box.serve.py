"""unclip_ms_per_box.serve: the host's time a box record in the port's
unclip (``postprocess.finish_device_rects`` over a call's batch): the self
time of the spans ``serve.unclip`` over the counter ``serve.rects_in`` (the
records kept on the device that the host finishes), both summed over the
calls of the device-only pass (``core/program_spans``). None where the port
recorded no such span or no record."""

from portbench.core.program_spans import PassSpans


def read(view):
    if view.info["traffic"]["kind"] != "serve":
        return None
    got = PassSpans(view, "serve.postprocess")
    spans = got.named("serve.unclip")
    rects = got.counter("serve.rects_in")
    if not spans or not rects:
        return None
    return sum(got.self_ms(s) for s in spans) / rects
