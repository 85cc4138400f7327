"""RubiksNet backbone on channel-last clips (N, T, H, W, C).

Counterpart of ``rubiksnet_tpu/nn/backbone.py`` (unrolled stages only): a
3x3 stride-2 stem, stages of RubiksShiftBlocks of widths (w, w, 2w, 4w, 8w),
then BN, ReLU and a spatial mean. Parameters are float32 and named as the
reference's torch modules (``layer3.12.as3.rubiks3d.shift``, OIHW conv
weights; for the rubiks3d-aq variant ``conv2.0.weight`` is the attention
shift, ``conv2.1.weight`` the 1x1 conv and ``as3.shift`` the (2, C) shift;
SE weights are ``se.fc.0.weight`` and ``se.fc.2.weight``); the compute
dtype is that of the input.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bn_relu import bn_relu_train, bn_train_plain
from ..ops.fused_block import BN_EPS, fold_bn
from ..parallel.mesh import all_reduce_sum, column_parallel, group_size
from ..parallel.temporal import reduction_groups
from .layers import AttentionShift, Rubiks3DWrap, RubiksShift2D, SELayer

VARIANTS = ("rubiks3d", "rubiks3d-aq")


def he_fan_out_normal_(weight: torch.Tensor, generator: torch.Generator):
    """N(0, 2 / fan_out) with fan_out = out * kh * kw, in place."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    with torch.no_grad():
        return weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                              generator=generator)


class BN(nn.Module):
    """Batch norm over the last axis, eps 1e-5, as flax's BatchNorm with
    momentum 0.9.

    Train mode normalizes with the batch statistics over every axis but the
    last, computed in at least float32 (flax's rule), and updates the running statistics in place:
    ``running = 0.9 * running + 0.1 * batch`` with the biased batch variance
    (torch's ``batch_norm`` would use the unbiased one). Under an active
    data or time group (``parallel``) the statistics are those of the
    global batch and clip: the sums are reduced over the groups with a
    differentiable all-reduce, so the backward is the global one too, as
    in a jitted JAX step over a sharded batch. Eval mode uses the running
    statistics. Either way the output is in the input's dtype.
    :meth:`relu` is ``relu(self(x))``, on the kernel pair of
    ``ops/bn_relu.py`` where :func:`kernel_route` says so.
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
        if not self.training:
            scale, bias = fold_bn(self.weight, self.bias, self.running_mean,
                                  self.running_var, self.eps)
            return (x.float() * scale + bias).to(x.dtype)
        groups = reduction_groups()
        var_mean = (functools.partial(global_var_mean, groups=groups)
                    if groups else None)
        return bn_train_plain(x, self.weight, self.bias, self.running_mean,
                              self.running_var, self.num_batches_tracked,
                              self.eps, var_mean)

    def relu(self, x, plain=False):
        """``relu(self(x))``: in train mode the kernel pair where
        :func:`kernel_route` takes x, which raises on a dtype or layout the
        kernels do not take; else the plain ops."""
        if kernel_route(x, self.training, plain):
            return bn_relu_train(x, self.weight, self.bias, self.running_mean,
                                 self.running_var, self.num_batches_tracked,
                                 self.eps)
        return torch.relu(self(x))


def kernel_route(x, training, plain):
    """Whether train-mode BN and its ReLU run on the kernel pair: a CUDA x
    in train mode with ``plain`` False and no active data or time group
    (whose statistics are all-reduced by :func:`global_var_mean`)."""
    return (training and not plain and x.device.type == "cuda"
            and not reduction_groups())


def global_var_mean(x, dims, groups):
    """Biased variance and mean of x over ``dims`` and over the ranks of
    every group (equal shards), in two passes, each sum all-reduced with
    its gradient."""
    count = math.prod(x.shape[d] for d in dims)
    total = x.sum(dims)
    for g in groups:
        total = all_reduce_sum(total, g)
        count *= group_size(g)
    mean = total / count
    d = x - mean
    sq = (d * d).sum(dims)
    for g in groups:
        sq = all_reduce_sum(sq, g)
    return sq / count, mean


class Conv1x1(nn.Module):
    """Bias-free 1x1 conv on channel-last input, weight (out, in, 1, 1);
    stride s samples rows and columns 0, s, 2s, ... Under tensor
    parallelism (``parallel.shard_params``) the weight holds this rank's
    output rows (``shard``) and the output's channels are gathered over
    the model group."""

    shard = None  # this rank's output rows, set by parallel.shard_params

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
        if self.shard is not None:
            return column_parallel(self.shard, x,
                                   lambda v: v @ w.t().to(v.dtype))
        return x @ w.t().to(x.dtype)


class StemConv(nn.Module):
    """Bias-free 3x3 stride-2 pad-1 conv of (N, T, H, W, 3) frames, weight
    (out, 3, 3, 3), in the input's dtype; sharded as :class:`Conv1x1`."""

    shard = None  # this rank's output rows, set by parallel.shard_params

    def __init__(self, out_planes, *, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty((out_planes, 3, 3, 3), dtype=torch.float32))
        if generator is not None:
            he_fan_out_normal_(self.weight, generator)

    def forward(self, video):
        if self.shard is not None:
            return column_parallel(self.shard, video, self._conv)
        return self._conv(video)

    def _conv(self, video):
        n, t, h, w, c = video.shape
        y = F.conv2d(video.reshape(n * t, h, w, c).permute(0, 3, 1, 2),
                     self.weight.to(video.dtype), stride=2, padding=1)
        y = y.permute(0, 2, 3, 1)
        return y.reshape(n, t, *y.shape[1:]).contiguous()


class RubiksShiftBlock(nn.Module):
    """Pre-activation block: BN1, ReLU, [rubiks3d-aq: attention temporal
    shift], 1x1 conv, BN2, ReLU, the shift (3D for rubiks3d, 2D for
    rubiks3d-aq; it carries the block's stride), [SE], 1x1 conv, plus a
    shortcut that is a strided 1x1 conv on the activated input when the
    stride or width changes, else the input. ``use_se`` is False, True
    (reduction 12) or the reduction."""

    def __init__(self, in_planes, out_planes, stride=1, quantize=False,
                 variant="rubiks3d", use_se=False, init_shift="uniform", *,
                 generator=None):
        super().__init__()
        if variant not in VARIANTS:
            raise NotImplementedError(f"unknown variant {variant!r}")
        self.in_planes, self.out_planes, self.stride = (
            in_planes, out_planes, stride)
        self.variant = variant
        mid = out_planes
        g = generator
        self.bn1 = BN(in_planes)
        conv2 = Conv1x1(in_planes, mid, generator=g)
        self.bn2 = BN(mid)
        if variant == "rubiks3d":
            self.conv2 = conv2
            self.as3 = Rubiks3DWrap(mid, stride=stride, quantize=quantize,
                                    generator=g)
        else:
            self.conv2 = nn.Sequential(AttentionShift(in_planes, generator=g),
                                       conv2)
            self.as3 = RubiksShift2D(mid, stride=stride, quantize=quantize,
                                     init_shift=init_shift, generator=g)
        if use_se:
            reduction = 12 if isinstance(use_se, bool) else int(use_se)
            self.se = SELayer(mid, reduction, generator=g)
        else:
            self.se = None
        self.conv3 = Conv1x1(mid, out_planes, generator=g)
        if stride != 1 or in_planes != out_planes:
            self.shortcut = Conv1x1(in_planes, out_planes, stride,
                                    generator=g)
        else:
            self.shortcut = None

    @property
    def conv2_1x1(self):
        """The 1x1 conv of conv2 (its second half for rubiks3d-aq)."""
        return self.conv2 if self.variant == "rubiks3d" else self.conv2[1]

    @property
    def aq_shift(self):
        """The attention shift of a rubiks3d-aq block, else None."""
        return None if self.variant == "rubiks3d" else self.conv2[0]

    def forward(self, x, plain=False):
        out = self.bn1.relu(x, plain)
        shortcut = x if self.shortcut is None else self.shortcut(out)
        out = self.bn2.relu(self.conv2(out), plain)
        out = self.as3(out, plain=plain)
        if self.se is not None:
            out = self.se(out)
        return self.conv3(out) + shortcut


class RubiksNetBackbone(nn.Module):
    """Stem, stages layer0..layer4 (repeats (1, r0, r1, r2, r3), strides
    (1, 2, 2, 2, 2)), bn_last. Returns per-frame features (N, T, 8w)."""

    def __init__(self, width, repeats, quantize=False, variant="rubiks3d",
                 use_se=False, init_shift="uniform", *, generator=None):
        super().__init__()
        self.width = width
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
                    variant, use_se, init_shift, generator=generator))
                in_planes = planes
            setattr(self, f"layer{stage_idx}", nn.ModuleList(blocks))
        self.bn_last = BN(8 * width)

    @property
    def feature_dim(self):
        return 8 * self.width

    def named_blocks(self):
        """(name, block) in order, names as the JAX package's layerS_B."""
        for s in range(self.num_stages):
            for b, blk in enumerate(getattr(self, f"layer{s}")):
                yield f"layer{s}_{b}", blk

    def pool(self, x, plain=False):
        """bn_last, ReLU, spatial mean: (N, T, H, W, C) -> (N, T, C)."""
        return self.bn_last.relu(x, plain).mean(dim=(2, 3))

    def forward(self, video, plain=False):
        x = self.conv1(video)
        for _, blk in self.named_blocks():
            x = blk(x, plain=plain)
        return self.pool(x, plain)
