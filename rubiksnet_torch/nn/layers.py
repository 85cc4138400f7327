"""RubiksShift layers on channel-last clips (N, T, H, W, C).

Counterpart of ``rubiksnet_tpu/nn/layers.py`` (RubiksShift3D and the
Rubiks3DWrap of the rubiks3d variant). RubiksShift2D, AttentionShift and
SELayer are not ported yet (ROADMAP).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.shift3d import rubiks_shift_3d


def uniform_shift_init(tensor: torch.Tensor, generator: torch.Generator,
                       scale: float = 1.0) -> torch.Tensor:
    """U(-scale, scale) shift init, in place."""
    with torch.no_grad():
        return tensor.uniform_(-scale, scale, generator=generator)


class RubiksShift3D(nn.Module):
    """Learnable per-channel fractional (T, H, W) shift; parameter ``shift``
    (3, C), rows (T, H, W). Its gradient is the reference's: unit-normalized
    per channel when ``normalize_grad``, the T row scaled by
    ``normalize_t_factor`` (a number or ``"auto"``) first."""

    def __init__(self, num_channels, stride=(1, 1, 1), padding=(0, 0, 0),
                 normalize_grad=True, normalize_t_factor=1.0, quantize=False,
                 *, generator=None):
        super().__init__()
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.normalize_grad = bool(normalize_grad)
        self.normalize_t_factor = normalize_t_factor
        self.quantize = bool(quantize)
        self.shift = nn.Parameter(
            torch.empty((3, num_channels), dtype=torch.float32))
        if generator is not None:
            uniform_shift_init(self.shift, generator)

    def forward(self, x, plain=False):
        """plain=True runs the gather form and its plain gradients on any
        device (the reference route); otherwise K1, K1-inverse and K4 on
        CUDA and the plain forms on the CPU."""
        return rubiks_shift_3d(x, self.shift, self.stride, self.padding,
                               self.normalize_grad, self.normalize_t_factor,
                               self.quantize, plain=plain)


class Rubiks3DWrap(nn.Module):
    """A 3D shift of stride (1, s, s) and padding 0 standing in for a 2D
    shift inside a block; child named ``rubiks3d`` so the state-dict key is
    ``...as3.rubiks3d.shift``."""

    def __init__(self, num_channels, stride=1, quantize=False, *,
                 generator=None):
        super().__init__()
        self.rubiks3d = RubiksShift3D(
            num_channels, stride=(1, stride, stride), padding=(0, 0, 0),
            quantize=quantize, generator=generator)

    def forward(self, x, plain=False):
        return self.rubiks3d(x, plain=plain)
