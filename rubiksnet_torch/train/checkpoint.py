"""Train-state checkpoint and bit-identical resume.

Counterpart of ``rubiksnet_tpu/train/checkpoint.py``. A checkpoint is
``torch.save`` of ``{"format": "rubiksnet-torch-trainstate", "version": 1,
"metadata", "model", "optimizer", "step"}``: the model's state dict
(parameters and BN running statistics), the optimizer's (momentum buffers
and groups) and the step count. A learning-rate schedule is a function of
the step: rebuild it and step it ``step`` times.
"""

from __future__ import annotations

import os

import torch

FORMAT = "rubiksnet-torch-trainstate"
VERSION = 1


def save_train_state(path, model, optimizer, step: int,
                     metadata: dict | None = None) -> None:
    """Write the train state to ``path`` atomically (through ``path +
    ".tmp"`` and ``os.replace``, so an interrupted save leaves no torn
    file). ``metadata`` is a dict of plain values (numbers, strings, lists).
    """
    payload = {
        "format": FORMAT,
        "version": VERSION,
        "metadata": dict(metadata or {}),
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "step": int(step),
    }
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_train_state(path, model, optimizer):
    """Restore a state written by :func:`save_train_state` into ``model``
    and ``optimizer`` (built as for the saved run) in place. Returns
    ``(step, metadata)``. Raises ``ValueError`` for another format or a
    newer version."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        got = payload.get("format") if isinstance(payload, dict) else None
        raise ValueError(
            f"{path} is not a train-state checkpoint (format={got!r})")
    if payload.get("version", 0) > VERSION:
        raise ValueError(
            f"{path} was written by a newer version "
            f"({payload['version']} > {VERSION})")
    model.load_state_dict(payload["model"])
    optimizer.load_state_dict(payload["optimizer"])
    return int(payload["step"]), dict(payload["metadata"])
