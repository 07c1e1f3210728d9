"""The port's own spans and counters, as its recorder
(``db_text_minimal_tpu_torch.utils.profiling.RECORDER``) kept them during
a traced run's profiled passes.

The port records while ``torch.profiler`` records, so during each of
``trace.profile``'s passes: the warm-up pass, the device-only pass and the
host-and-device pass, each of ``view.units`` steps or calls and so of as
many roots of each name. The readers take the device-only pass, whose
host runs unslowed by the recording of every ATen operator: the
next-to-last ``view.units`` roots of a name (all of them where fewer than
two passes' roots were kept). A port that keeps no recorder, or kept no
such span, gives no roots, and a reader then returns None.
"""

from __future__ import annotations


def recorder():
    """The port's recorder, or None where the port has none."""
    from db_text_minimal_tpu_torch.utils import profiling

    return getattr(profiling, "RECORDER", None)


class PassSpans:
    """The spans of the device-only pass under its roots named ``root``."""

    def __init__(self, view, root: str, rec=None):
        rec = rec if rec is not None else recorder()
        spans = list(rec.spans) if rec is not None else []
        roots = [s for s in spans if s.name == root and s.parent is None]
        n = view.units
        self.roots = roots[-2 * n:-n] if n and len(roots) >= 2 * n \
            else roots
        seqs = {r.seq for r in self.roots}
        self.spans = [s for s in spans if s.root in seqs]
        self.children: dict = {}
        for s in self.spans:
            self.children.setdefault(s.parent, []).append(s)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def under(self, root, name: str) -> list:
        """The spans named ``name`` in ``root``'s tree."""
        return [s for s in self.spans
                if s.root == root.seq and s.name == name]

    def self_ms(self, span) -> float:
        """The span's host time less the part its children cover (they
        nest inside it, one after another)."""
        return span.host_ms - sum(c.host_ms
                                  for c in self.children.get(span.seq, []))

    def counter(self, name: str) -> int:
        return sum((s.counters or {}).get(name, 0) for s in self.spans)


def phase_device_ms(view, phase: str):
    """The mean over the pass's training steps of the device time of the
    step's spans named ``phase``; None where none was recorded."""
    if view.info["traffic"]["kind"] != "train":
        return None
    got = PassSpans(view, "train.step")
    per_step = []
    for root in got.roots:
        times = [s.device_ms for s in got.under(root, phase)]
        if not times or None in times:
            return None
        per_step.append(sum(times))
    return sum(per_step) / len(per_step) if per_step else None
