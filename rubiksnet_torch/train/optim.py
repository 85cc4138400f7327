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

from collections.abc import Callable

import torch

from ..models.rubiksnet import Linear
from ..nn.backbone import BN, Conv1x1, StemConv
from ..nn.layers import AttentionShift, Dense, RubiksShift2D, RubiksShift3D

GROUPS = ("weight", "bias", "shift")


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
    scheduler once per optimizer step (``make_train_step`` does).
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
