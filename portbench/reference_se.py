"""The plain reference of the SE tier (RubiksNet-Small): ``reference.py``'s
RubiksNet with a squeeze-and-excitation gate in every block, plain float32
PyTorch with TF32 off. It extends the frozen ``reference.py`` by import and
imports nothing of the program.

The source is StanfordVL/RubiksNet: ``rubiksnet/models.py:28-43`` (tier
``small``: width 72, repeats 3/4/6/3, ``use_se``) and
``rubiksnet/backbone.py:56-71, 94`` (``SELayer``, reduction 12, between the
shift and the block's last 1x1 conv). A block, channel-last:

    a   = relu(bn1(x))
    sc  = x                        (or Wsc . a[:, :, ::s, ::s] at an entry)
    v   = shift3d_s(relu(bn2(W2 . a)))
    g   = sigmoid(F2 . relu(F1 . mean_HW(v)))      per frame
    out = W3 . (v * g) + sc

F1 is C -> C/12 and F2 C/12 -> C, both without biases; the mean is over H
and W of each frame at the shifted activation's (strided) size, so the
gate is (N, T, C). The dense layers are named as the program's
``SELayer``: ``{block}.se.fc.0.weight`` (C/12, C) and
``{block}.se.fc.2.weight`` (C, C/12).

Departures from the source, beside ``reference.py``'s: the gate's means
are per frame on channel-last clips (the source's 2D backbone folds T into
the batch, which is the same mean). The SE weights are drawn from the
seed after the other weights, so a configuration without SE draws exactly
``reference.make_weights``' weights, and at twice the deviation of a dense
layer's N(0, 1 / fan_in). At that init 90% of Small's gates read 0.46-0.54,
a near-constant halving of the branch that a check of the logits sees and
little else: a gate moved after W3 changes the logits by 1.0%. At twice it
they read 0.36-0.64, and that fault moves the logits by 4.5% (both at the
CPU tests' size, ``tests/test_torch_small_se_reference.py``). With
``precision="fp8"`` F1's and F2's operands are rounded as every other
matrix product's are.
"""

from __future__ import annotations

import math

import torch

from . import reference
from .reference import Reference as _Plain
from .reference import Shift3D, block_list

SE_REDUCTION = 12  # the source's, where the configuration names none
SE_GAIN = 2.0  # the SE weights' deviation over N(0, 1 / fan_in)'s


def se_spec(cfg):
    """(name, shape, init) of the SE weights of every block; empty without
    ``use_se``."""
    if not cfg.get("use_se", False):
        return []
    reduction = cfg.get("se_reduction", SE_REDUCTION)
    out = []
    for p, _, cout, _ in block_list(cfg):
        cr = cout // reduction
        out += [(f"{p}.se.fc.0.weight", (cr, cout), "se"),
                (f"{p}.se.fc.2.weight", (cout, cr), "se")]
    return out


def param_spec(cfg):
    """``reference.param_spec`` and the SE weights."""
    return reference.param_spec(cfg) + se_spec(cfg)


def make_weights(cfg, generator, device):
    """``reference.make_weights``, then the SE weights from one more normal
    draw of the same generator, each N(0, SE_GAIN**2 / fan_in)."""
    out = reference.make_weights(cfg, generator, device)
    spec = se_spec(cfg)
    if not spec:
        return out
    normal = torch.randn(sum(math.prod(s) for _, s, _ in spec),
                         generator=generator, device=device)
    a = 0
    for name, shape, _ in spec:
        size = math.prod(shape)
        out[name] = (normal[a:a + size].view(shape)
                     * (SE_GAIN / math.sqrt(shape[1]))).clone()
        a += size
    return out


class Reference(_Plain):
    """``reference.Reference`` with the SE gate in every block where the
    configuration has ``use_se``; without it, the plain reference itself.
    The rubiks3d variant only with SE (no cell runs Small-AQ)."""

    def __init__(self, cfg, weights, precision="float32"):
        super().__init__(cfg, weights, precision)
        self.se = bool(cfg.get("use_se", False))
        if self.se and self.aq:
            raise NotImplementedError("the SE reference is rubiks3d only")

    def gate(self, v, prefix):
        """sigmoid(F2 . relu(F1 . mean over H, W)) of (N, T, H, W, C): (N,
        T, C)."""
        p = self.p
        squeezed = v.mean(dim=(2, 3))
        hidden = torch.relu(self._mm(squeezed, p[f"{prefix}.se.fc.0.weight"]))
        return torch.sigmoid(self._mm(hidden, p[f"{prefix}.se.fc.2.weight"]))

    def _block(self, x, prefix, cin, cout, stride, train):
        if not self.se:
            return super()._block(x, prefix, cin, cout, stride, train)
        p = self.p
        out = torch.relu(self._bn(x, f"{prefix}.bn1", train))
        if stride != 1 or cin != cout:
            sc = out[:, :, ::stride, ::stride]
            shortcut = self._mm(sc, p[f"{prefix}.shortcut.weight"])
        else:
            shortcut = x
        out = self._mm(out, p[f"{prefix}.conv2.weight"])
        out = torch.relu(self._bn(out, f"{prefix}.bn2", train))
        out = Shift3D.apply(out, p[f"{prefix}.as3.rubiks3d.shift"], stride)
        out = out * self.gate(out, prefix)[:, :, None, None, :]
        return self._mm(out, p[f"{prefix}.conv3.weight"]) + shortcut
