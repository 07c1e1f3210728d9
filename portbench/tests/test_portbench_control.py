"""The lower-precision control comes out not correct: in a training cell
the reference computed in int8 in the program's place, in the serving
cell the port's own int8 forward; each read by the cell's own comparison
against its limits, at a size a CPU test run holds."""

from __future__ import annotations

import pytest

from conftest import tiny_context

from portbench import calibrate
from portbench.core import compare


@pytest.mark.parametrize("workload,size", [
    ("r18_train_b16", 64), ("r50dcn_train_b16", 64), ("r18_serve_b32", 64)])
def test_the_control_is_not_correct(workload, size):
    _, ctx = tiny_context(workload)
    key = "image_size" if ctx.traffic["kind"] == "train" else "canvas"
    ctx.traffic[key] = size
    ctx.traffic["long_side"] = size * 3 // 2
    fn = (calibrate.train_readings if ctx.traffic["kind"] == "train"
          else calibrate.serve_readings)
    rows = fn(ctx, 2 ** 31 + 101, ["program", "control"])
    got = {r["mode"]: r["numbers"] for r in rows}
    assert compare.check(got["program"], ctx.limits), got["program"]
    assert not compare.check(got["control"], ctx.limits), got["control"]
