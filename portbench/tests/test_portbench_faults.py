"""The correctness check fails a broken timed path. Each test skips the
harness's look for a card and drives the rest of a run (``run_cell``) at
a tiny size on the CPU, with the cells' own limits, with the timed path
unbroken (correct) and with each fault the cell can have (not correct):
an answer altered where it is produced; in training, a step that leaves
its state unchanged and one that takes the mean over half of the batch.
A cell on one chip has no exchange between chips to leave out."""

import json

import pytest
import torch

from portbench import run, spec
from rubiksnet_torch.models.fused_infer import FusedExecutor
from rubiksnet_torch.train.steps import TrainStep

from .tiny import cell

LIMITS = {"serve": "large.serve.b64", "train": "large.train.b32",
          "evaluate": "large.eval.1clip"}


def limits(kind):
    path = spec.ROOT / "portbench" / "limits" / f"{LIMITS[kind]}.json"
    with open(path) as f:
        return json.load(f)


def run_tiny(kind, **overrides):
    return run.run_cell(cell(kind, limits(kind), **overrides), 2**31 + 5,
                        0.2, False, torch.device("cpu"))


def altered_answer(monkeypatch):
    """The executor's logits with the first clip's answer rolled by one
    class."""
    call = FusedExecutor.__call__

    def broken(self, video, clips=None):
        out = call(self, video, clips).clone()
        out[0] = out[0].roll(1)
        return out

    monkeypatch.setattr(FusedExecutor, "__call__", broken)


@pytest.mark.parametrize("kind", ["serve", "evaluate"])
def test_sound_run_is_correct(kind):
    result = run_tiny(kind)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("kind", ["serve", "evaluate"])
def test_altered_answer_is_not_correct(kind, monkeypatch):
    altered_answer(monkeypatch)
    assert not run_tiny(kind)["correct"]


def test_sound_train_step_is_correct():
    result = run_tiny("train")
    assert result["correct"], result["checks"]


def test_unchanged_state_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None:
                        None)
    assert not run_tiny("train")["correct"]


def test_half_batch_is_not_correct(monkeypatch):
    call = TrainStep.__call__

    def half(self, video, labels):
        n = video.shape[0] // 2
        return call(self, video[:n], labels[:n])

    monkeypatch.setattr(TrainStep, "__call__", half)
    assert not run_tiny("train")["correct"]


def test_altered_loss_is_not_correct(monkeypatch):
    call = TrainStep.__call__

    def altered(self, video, labels):
        out = call(self, video, labels)
        return {**out, "loss": out["loss"] * 1.01}

    monkeypatch.setattr(TrainStep, "__call__", altered)
    assert not run_tiny("train")["correct"]
