"""The numbers that decide ``correct``, each from two readings: what the
timed path produced and what the reference computes.

Training (three steps on three distinct batches):
- ``loss_gap``: the largest |L − L_ref| / |L_ref| over the steps;
  ``loss1_gap`` that of the first step;
- ``grad_gap``: over the parameters, the largest gap between the norm of
  the first step's gradient and the reference's, over the larger of the
  reference's norm of that parameter and the median parameter's;
  ``grad_gap_median`` the median parameter's gap; ``grad_gap_neck_head``
  the mean gap of the parameters of the FPN neck and the DB head, the
  layers next to the loss: the deep backbone's bfloat16 rounding is
  not in them, and a step below bfloat16 shows there;
- ``update_gap`` and ``update_gap_median``: the same of each parameter's
  change over the steps.
Parameters whose reference gradient is under a thousandth of the median
parameter's (a conv bias before a batch norm: its gradient is rounding
noise, and Adam moves it by noise alone) are left out of the gaps. A
cell's limits (``portbench/checks/<cell>.json``) name the numbers it
compares; the others are reported as readings.

Serving (the sampled calls' batches):
- ``prob_gap``: the mean |P − P_ref| over every pixel of the prob maps
  the forward served, against the reference's float32 forward;
- ``box_unmatched``: the share of boxes, served or the reference's (its
  box extraction run on the served prob maps), with no partner within
  ``BOX_TOL_PX`` pixels at every corner and a score within ``SCORE_TOL``
  of its own. The program's search for the least rectangle steps its
  angle and may end near a tie at another orientation: a served box also
  matches the reference's box of the same component at another angle,
  where that rectangle's area is within the share ``RECT_TIE`` of the
  least;
- ``rect_excess``: the largest such share over the matched pairs;
- ``score_gap``: the largest score gap over the pairs matched by corners;
- ``boxes``: the boxes compared an image set (served and the reference's
  together, halved), held to a least count so that the comparison is not
  of empty sets.
"""

from __future__ import annotations

import numpy as np

from ..reference import postprocess as RP

# the steps that set-up drives through the window's call and the reference
# follows; the limits in ``portbench/checks/`` were read at this count
CHECK_STEPS = 3
NOISE_SHARE = 1e-3
# the parameters of the FPN neck and the DB head, by the reference's names
NECK_AND_HEAD = ("segmentation_body.", "segmentation_head.")
BOX_TOL_PX = 2.0
RECT_TIE = 0.3
SCORE_TOL = 1e-4


def kept_leaves(ref_grads: dict) -> list[str]:
    med = float(np.median(list(ref_grads.values())))
    return [k for k, v in ref_grads.items() if v >= NOISE_SHARE * med]


def leaf_gaps(got: dict, ref: dict, keep: list[str]) -> dict:
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(got[k] - ref[k]) / max(ref[k], med) for k in keep}


def train_readings(got: dict, ref: dict) -> tuple[dict, dict]:
    """(numbers, details) of a run's three steps against the
    reference's; both dicts as ``reference.train.run_steps`` returns."""
    keep = kept_leaves(ref["grad_norms"])
    loss = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                ref["losses"])]
    grad = leaf_gaps(got["grad_norms"], ref["grad_norms"], keep)
    upd = leaf_gaps(got["update_norms"], ref["update_norms"], keep)
    top = [v for k, v in grad.items() if k.startswith(NECK_AND_HEAD)]
    numbers = {"loss_gap": max(loss), "loss1_gap": loss[0],
               "grad_gap": max(grad.values()),
               "grad_gap_median": float(np.median(list(grad.values()))),
               "grad_gap_neck_head": float(np.mean(top)),
               "update_gap": max(upd.values()),
               "update_gap_median": float(np.median(list(upd.values())))}
    worst = sorted(grad, key=grad.get)[-5:][::-1]
    details = {"losses": got["losses"], "ref_losses": ref["losses"],
               "grad_worst_leaves": {k: grad[k] for k in worst},
               "update_worst_leaf": max(upd, key=upd.get),
               "leaves_kept": len(keep),
               "leaves_left_out": sorted(set(ref["grad_norms"]) - set(keep))}
    return numbers, details


def box_readings(served: list, ref: list) -> dict:
    """``served``: per image (boxes, scores); ``ref``: per image what
    ``reference.postprocess.boxes`` returns."""
    matched = total = 0
    gap = worst = 0.0
    for (a, sa), (b, sb, cands) in zip(served, ref):
        pairs = RP.match(a, b, BOX_TOL_PX, cands, RECT_TIE)
        for i, j, excess in pairs:
            g = abs(float(sa[i]) - float(sb[j]))
            gap = max(gap, g)
            worst = max(worst, excess)
            matched += 2 * (g <= SCORE_TOL)
        total += len(a) + len(b)
    return {"box_unmatched": (total - matched) / total if total else 0.0,
            "score_gap": gap, "rect_excess": worst, "boxes": total / 2}


def within(value: float, limit) -> bool:
    """A limit is a number the value may not pass, or ``{"at_least": n}``
    (a count that has to reach ``n``)."""
    if not np.isfinite(value):
        return False
    if isinstance(limit, dict):
        return value >= limit["at_least"]
    return value <= limit


def describe(limit) -> str:
    if isinstance(limit, dict):
        return f"at least {limit['at_least']!r}"
    return f"limit {limit!r}"


def check(numbers: dict, limits: dict) -> bool:
    """True when every number with a limit is within it."""
    return all(within(numbers[k], v) for k, v in limits.items())
