"""upload_host_ms.serve: the host's time a call in the port's upload of
the uint8 batch (the span ``serve.upload`` in ``handler.inference``: a
pageable host-to-device copy, which the host waits for), averaged over the
calls of the device-only pass (``core/program_spans``). None where the port
recorded no such span."""

from portbench.core.program_spans import PassSpans


def read(view):
    if view.info["traffic"]["kind"] != "serve":
        return None
    got = PassSpans(view, "serve.inference")
    per_call = [sum(s.host_ms for s in got.under(root, "serve.upload"))
                for root in got.roots]
    if not per_call or not got.named("serve.upload"):
        return None
    return sum(per_call) / len(per_call)
