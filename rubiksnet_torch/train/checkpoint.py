"""Train-state checkpoint and bit-identical resume.

Counterpart of ``rubiksnet_tpu/train/checkpoint.py``. A checkpoint is
``torch.save`` of ``{"format": "rubiksnet-torch-trainstate", "version": 1,
"metadata", "model", "optimizer", "step"}``: the model's state dict
(parameters and BN running statistics), the optimizer's (momentum buffers
and groups) and the step count. A learning-rate schedule is a function of
the step: rebuild it and step it ``step`` times.

Under tensor parallelism the checkpoint holds the full state, the sharded
weights and their momentum gathered over the model group, so it loads
into one process; loading cuts it to the rows of a sharded model
(``parallel.shard_params``), so a one-process checkpoint resumes over a
model group too.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..parallel.mesh import (
    gather_params,
    gather_shard,
    shard_state,
    sharded_modules,
)

FORMAT = "rubiksnet-torch-trainstate"
VERSION = 1


def _sharded_state(optimizer, model):
    """{index in the optimizer's state dict: the Shard of its parameter}
    for the sharded weights of ``model``."""
    shards = {id(m.weight): m.shard for _, m in sharded_modules(model)}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return {i: shards[id(p)] for i, p in enumerate(params)
            if id(p) in shards}


def _map_optimizer_state(state, shards, fn):
    """``state`` (an optimizer's state dict) with ``fn(tensor, shard)``
    applied to each per-parameter tensor (the momentum) of a sharded
    weight, in the order of the indices."""
    state = dict(state, state=dict(state["state"]))
    for i in sorted(shards):
        if i in state["state"]:
            state["state"][i] = {
                k: fn(v, shards[i]) if torch.is_tensor(v) and v.ndim else v
                for k, v in state["state"][i].items()}
    return state


def save_train_state(path, model, optimizer, step: int,
                     metadata: dict | None = None,
                     model_group=None) -> None:
    """Write the train state to ``path`` atomically (through ``path +
    ".tmp"`` and ``os.replace``, so an interrupted save leaves no torn
    file). ``metadata`` is a dict of plain values (numbers, strings, lists).

    In a process group only the world's first rank writes. A model sharded
    over ``model_group`` is saved whole: every rank of the group calls this
    alike, and the sharded weights and their momentum are gathered over it.
    """
    model_state = gather_params(model, model_group)
    opt_state = _map_optimizer_state(
        optimizer.state_dict(), _sharded_state(optimizer, model),
        lambda t, shard: gather_shard(t, shard, model_group))
    if dist.is_initialized() and dist.get_rank():
        return
    payload = {
        "format": FORMAT,
        "version": VERSION,
        "metadata": dict(metadata or {}),
        "model": model_state,
        "optimizer": opt_state,
        "step": int(step),
    }
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_train_state(path, model, optimizer):
    """Restore a state written by :func:`save_train_state` into ``model``
    and ``optimizer`` (built as for the saved run) in place; a sharded
    model takes its rows of each sharded weight and its momentum. Returns
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
    model.load_state_dict(shard_state(model, payload["model"]))
    optimizer.load_state_dict(_map_optimizer_state(
        payload["optimizer"], _sharded_state(optimizer, model),
        lambda t, shard: t[shard.rows]))
    return int(payload["step"]), dict(payload["metadata"])
