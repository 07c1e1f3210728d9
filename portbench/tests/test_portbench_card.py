"""On the card: the command runs each cell briefly, traced, and prints a
correct result line with the cell's per-layer metrics. Run there with
``python -m pytest -m cuda portbench/tests``; skipped without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

from portbench.core.registry import Registry


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in Registry(ROOT)
                                      .bench["workloads"]])
def test_a_short_traced_run_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 19), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    names = {m["name"] for m in Registry(ROOT).metrics("per_layer",
                                                       workload)}
    assert set(result["metrics"]) <= names and result["metrics"]
    for m in result["metrics"].values():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 105
