"""A whole run, past the harness's look for a card, at a small size on the
CPU: sound, it comes out correct; with the timed path broken underneath in
each way the cell can break, ``correct`` comes out false."""

from __future__ import annotations

import pytest

from conftest import tiny_context

from portbench.core import harness
from portbench.core.serve_cell import ProgramServer
from portbench.core.train_cell import ProgramTrainer


class StateUnchanged(ProgramTrainer):
    """Steps that compute the loss and its gradient but leave the state as
    it was."""

    def __init__(self, *args):
        super().__init__(*args)
        self.state.optimizer.step = lambda *a, **k: None


class HalfBatch(ProgramTrainer):
    """Steps on the first half of each batch: the loss a mean over it."""

    def upload(self, batch):
        half = batch["img"].shape[0] // 2
        return super().upload({k: v[:half] for k, v in batch.items()})


class AlteredAnswer(ProgramServer):
    """The served boxes of the first image gain a box of its own."""

    def call(self, batch):
        preds, out = super().call(batch)
        out[0]["boxes"].append([[4.0, 4.0], [20.0, 4.0], [20.0, 12.0],
                                [4.0, 12.0]])
        out[0]["scores"].append(0.9)
        return preds, out


class HalfServed(ProgramServer):
    """The forward runs on the first half of the batch and serves its maps
    for both halves."""

    def call(self, batch):
        half = len(batch) // 2
        preds, out = super().call(batch[:half])
        import torch

        return torch.cat([preds, preds]), out + out


def _run(workload, factory=None):
    reg, ctx = tiny_context(workload)
    if factory is not None:
        ctx.program_factory = factory
    result, lines = harness.run_cell(reg, ctx)
    assert len(lines) == len(ctx.limits)
    return result


@pytest.mark.parametrize("workload", ["r18_train_b16", "r18_serve_b32"])
def test_a_sound_run_is_correct(workload):
    result = _run(workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", [
    ("r18_train_b16", StateUnchanged), ("r18_train_b16", HalfBatch),
    ("r18_serve_b32", AlteredAnswer), ("r18_serve_b32", HalfServed)],
    ids=["state_unchanged", "half_batch", "altered_answer", "half_served"])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    result = _run(workload, fault)
    assert not result["correct"], result["checks"]
