"""SGD with the reference's parameter groups and shift learning rate.

Counterpart of ``rubiksnet_tpu/train/optim.py``. Three groups: ``weight``
(conv, ``new_fc``, attention-shift and SE dense weights, decayed), ``bias`` (biases and BN weight and
bias, not decayed) and ``shift`` (the shift parameters at ``lr *
lr_shift_mult``, not decayed). Parameters are routed by the module that owns
them, not by name: a BN scale is named ``weight`` in torch but belongs to
``bias``.

``torch.optim.SGD`` with momentum m and weight decay d takes ``buf = m * buf
+ grad + d * p`` (the first step ``buf = grad + d * p``) and ``p -= lr *
buf``: the same update as ``optax.add_decayed_weights(d)`` followed by
``optax.sgd(lr, momentum=m)``.
"""

from __future__ import annotations

import math
from collections.abc import Callable

import torch

from ..models.rubiksnet import Linear
from ..nn.backbone import BN, Conv1x1, StemConv
from ..nn.layers import AttentionShift, Dense, RubiksShift2D, RubiksShift3D

GROUPS = ("weight", "bias", "shift")
SCHEDULES = ("constant", "cosine")


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule: ``init`` to ``end`` over ``steps`` steps, then
    held; ``init`` throughout where ``steps`` <= 0."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def lr_schedule(kind: str, lr: float, warmup_steps: int = 0,
                total_steps: int = 0) -> Callable[[int], float]:
    """The learning rate as a function of the optimizer step (0 for the
    first update), equal to what scripts/train.py builds from optax:

    * ``"cosine"``: ``warmup_cosine_decay_schedule`` from ``0`` (or from
      ``lr`` without warmup) to ``lr`` over ``warmup_steps``, then a cosine
      decay to 0 at ``max(total_steps, warmup_steps + 1)``, held there;
    * ``"constant"`` with ``warmup_steps``: ``linear_schedule(0, lr,
      warmup_steps)``, then ``lr``;
    * ``"constant"``: ``lr``.

    Give it to :func:`sgd_with_shift_mult` as ``lr``: every group takes it
    times its multiplier.
    """
    if kind not in SCHEDULES:
        raise ValueError(f"unknown lr schedule {kind!r}")
    lr = float(lr)
    if kind == "cosine":
        warmup = int(warmup_steps)
        decay = max(int(total_steps), warmup + 1) - warmup
        init = 0.0 if warmup else lr

        def cosine(step: int) -> float:
            if step < warmup:
                return _linear(init, lr, warmup, step)
            count = min(float(step - warmup), float(decay))
            return lr * (0.5 * (1.0 + math.cos(math.pi * count / decay)))

        return cosine
    if warmup_steps:
        return lambda step: _linear(0.0, lr, int(warmup_steps), step)
    return lambda step: lr


def param_groups(model: torch.nn.Module) -> dict:
    """{group name: [parameters]} of a RubiksNet; raises for a parameter of
    a module type it does not know."""
    groups = {g: [] for g in GROUPS}
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (RubiksShift3D, RubiksShift2D)) and (
                    name == "shift"):
                groups["shift"].append(p)
            elif isinstance(mod, BN) or (isinstance(mod, Linear)
                                         and name == "bias"):
                groups["bias"].append(p)
            elif isinstance(mod, (Conv1x1, StemConv, Linear, AttentionShift,
                                  Dense)):
                groups["weight"].append(p)
            else:
                raise TypeError(
                    f"no optimizer group for {type(mod).__name__}.{name}")
    return groups


def sgd_with_shift_mult(model, lr: float | Callable[[int], float],
                        lr_shift_mult: float = 0.1, momentum: float = 0.9,
                        weight_decay: float = 1e-4):
    """``torch.optim.SGD`` over the three groups (named in each group's
    ``"name"``).

    ``lr`` is a number, or a schedule ``step -> lr``: then the result is
    ``(optimizer, scheduler)``, a ``LambdaLR`` whose factor ``lr(step)``
    applies to every group (the shift group keeps its multiplier). Step the
    scheduler once per optimizer step (``make_train_step`` does); after
    restoring a checkpoint of step ``s``, :func:`resume_schedule` sets it
    to continue from there.
    """
    groups = param_groups(model)
    base = 1.0 if callable(lr) else float(lr)
    mult = {"weight": 1.0, "bias": 1.0, "shift": lr_shift_mult}
    decay = {"weight": weight_decay, "bias": 0.0, "shift": 0.0}
    opt = torch.optim.SGD(
        [{"params": groups[g], "name": g, "lr": base * mult[g],
          "weight_decay": decay[g]} for g in GROUPS],
        lr=base, momentum=momentum)
    if callable(lr):
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr)
    return opt


def resume_schedule(scheduler, step: int) -> None:
    """Continue ``scheduler`` (a ``LambdaLR`` of :func:`sgd_with_shift_mult`)
    at optimizer step ``step``: the next update takes ``lr(step)`` times its
    group's multiplier, as it would have in an uninterrupted run."""
    scheduler.last_epoch = int(step)
    for group, base, lam in zip(scheduler.optimizer.param_groups,
                                scheduler.base_lrs, scheduler.lr_lambdas):
        group["lr"] = base * lam(int(step))
    scheduler._last_lr = [g["lr"] for g in scheduler.optimizer.param_groups]
