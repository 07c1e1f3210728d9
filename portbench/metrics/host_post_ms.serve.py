"""host_post_ms.serve: the host's own time a call in the rect postprocess
and the handler around it, on the call's critical path: for each harness
span around ``handler.postprocess_boxes``, the time from the end of the
last device operation inside it (the copy of the box records to the host,
which the span waits for) to the span's end (the host's unclip, ordering
and the result's lists), averaged over the profiled calls. Spans and
device operations are both taken from the trace's second pass, which
records them on one clock."""

from portbench.core.trace import PREFIX


def read(view):
    if view.info["traffic"]["kind"] != "serve":
        return None
    tails = []
    for name, s, e in view.spans:
        if name != PREFIX + "postprocess_boxes":
            continue
        ends = [oe for _, os_, oe in view.span_ops if s <= oe <= e]
        if ends:
            tails.append(e - max(ends))
    if not tails:
        return None
    return sum(tails) / len(tails) / 1e3
