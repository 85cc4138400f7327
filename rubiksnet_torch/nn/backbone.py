"""RubiksNet backbone on channel-last clips (N, T, H, W, C), inference.

Counterpart of ``rubiksnet_tpu/nn/backbone.py`` (unrolled stages only): a
3x3 stride-2 stem, stages of RubiksShiftBlocks of widths (w, w, 2w, 4w, 8w),
then BN, ReLU and a spatial mean. Parameters are float32 and named as the
reference's torch modules (``layer3.12.as3.rubiks3d.shift``, OIHW conv
weights); the compute dtype is that of the input.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_block import BN_EPS, fold_bn
from .layers import Rubiks3DWrap


def he_fan_out_normal_(weight: torch.Tensor, generator: torch.Generator):
    """N(0, 2 / fan_out) with fan_out = out * kh * kw, in place."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    with torch.no_grad():
        return weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                              generator=generator)


class BN(nn.Module):
    """Batch norm over the last axis with running statistics, eps 1e-5.

    Inference only: batch-statistics mode (training) is not ported yet.
    """

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "batch-statistics BN (training) is not ported yet (ROADMAP "
                "A6); call .eval()")
        scale, bias = fold_bn(self.weight, self.bias, self.running_mean,
                              self.running_var, self.eps)
        return (x.float() * scale + bias).to(x.dtype)


class Conv1x1(nn.Module):
    """Bias-free 1x1 conv on channel-last input, weight (out, in, 1, 1);
    stride s samples rows and columns 0, s, 2s, ..."""

    def __init__(self, in_planes, out_planes, stride=1, *, generator=None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(
            torch.empty((out_planes, in_planes, 1, 1), dtype=torch.float32))
        if generator is not None:
            he_fan_out_normal_(self.weight, generator)

    def forward(self, x):
        if self.stride > 1:
            x = x[:, :, ::self.stride, ::self.stride]
        w = self.weight.reshape(self.weight.shape[0], -1)
        return x @ w.t().to(x.dtype)


class StemConv(nn.Module):
    """Bias-free 3x3 stride-2 pad-1 conv of (N, T, H, W, 3) frames, weight
    (out, 3, 3, 3), in the input's dtype."""

    def __init__(self, out_planes, *, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty((out_planes, 3, 3, 3), dtype=torch.float32))
        if generator is not None:
            he_fan_out_normal_(self.weight, generator)

    def forward(self, video):
        n, t, h, w, c = video.shape
        y = F.conv2d(video.reshape(n * t, h, w, c).permute(0, 3, 1, 2),
                     self.weight.to(video.dtype), stride=2, padding=1)
        y = y.permute(0, 2, 3, 1)
        return y.reshape(n, t, *y.shape[1:]).contiguous()


class RubiksShiftBlock(nn.Module):
    """Pre-activation block: BN1, ReLU, 1x1 conv, BN2, ReLU, 3D shift (the
    block's stride), 1x1 conv, plus a shortcut that is a strided 1x1 conv on
    the activated input when the stride or width changes, else the input."""

    def __init__(self, in_planes, out_planes, stride=1, quantize=False, *,
                 generator=None):
        super().__init__()
        self.in_planes, self.out_planes, self.stride = (
            in_planes, out_planes, stride)
        mid = out_planes
        g = generator
        self.bn1 = BN(in_planes)
        self.conv2 = Conv1x1(in_planes, mid, generator=g)
        self.bn2 = BN(mid)
        self.as3 = Rubiks3DWrap(mid, stride=stride, quantize=quantize,
                                generator=g)
        self.conv3 = Conv1x1(mid, out_planes, generator=g)
        if stride != 1 or in_planes != out_planes:
            self.shortcut = Conv1x1(in_planes, out_planes, stride,
                                    generator=g)
        else:
            self.shortcut = None

    def forward(self, x, plain=False):
        out = torch.relu(self.bn1(x))
        shortcut = x if self.shortcut is None else self.shortcut(out)
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.as3(out, plain=plain)
        return self.conv3(out) + shortcut


class RubiksNetBackbone(nn.Module):
    """Stem, stages layer0..layer4 (repeats (1, r0, r1, r2, r3), strides
    (1, 2, 2, 2, 2)), bn_last. Returns per-frame features (N, T, 8w)."""

    def __init__(self, width, repeats, quantize=False, *, generator=None):
        super().__init__()
        self.conv1 = StemConv(width, generator=generator)
        widths = [(width, 1, 1), (width, repeats[0], 2),
                  (2 * width, repeats[1], 2), (4 * width, repeats[2], 2),
                  (8 * width, repeats[3], 2)]
        in_planes = width
        self.num_stages = len(widths)
        for stage_idx, (planes, repeat, stride) in enumerate(widths):
            blocks = []
            for b in range(repeat):
                blocks.append(RubiksShiftBlock(
                    in_planes, planes, stride if b == 0 else 1, quantize,
                    generator=generator))
                in_planes = planes
            setattr(self, f"layer{stage_idx}", nn.ModuleList(blocks))
        self.bn_last = BN(8 * width)

    def named_blocks(self):
        """(name, block) in order, names as the JAX package's layerS_B."""
        for s in range(self.num_stages):
            for b, blk in enumerate(getattr(self, f"layer{s}")):
                yield f"layer{s}_{b}", blk

    def pool(self, x):
        """bn_last, ReLU, spatial mean: (N, T, H, W, C) -> (N, T, C)."""
        return torch.relu(self.bn_last(x)).mean(dim=(2, 3))

    def forward(self, video, plain=False):
        x = self.conv1(video)
        for _, blk in self.named_blocks():
            x = blk(x, plain=plain)
        return self.pool(x)
