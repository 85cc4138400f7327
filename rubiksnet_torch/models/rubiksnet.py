"""RubiksNet model: backbone, ``new_fc`` head and the TSN mean over frames.

Counterpart of ``rubiksnet_tpu/models/rubiksnet.py``. Input is channel-last
normalized RGB video (N, T, H, W, 3); :func:`from_ntchw` converts the
reference's (N, T, 3, H, W).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.backbone import RubiksNetBackbone

TIERS = {
    # tier -> (width, repeats, use_se)
    "tiny": (54, (3, 4, 6, 3), False),
    "small": (72, (3, 4, 6, 3), True),
    "medium": (72, (3, 4, 23, 3), False),
    "large": (72, (3, 8, 36, 3), False),
}

VARIANTS = ("rubiks3d", "rubiks3d-aq")


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """Truncated normal (2 std) with variance 1 / fan_in, in place."""
    fan_in = weight.shape[1]
    # Std of the unit normal truncated to [-2, 2].
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class Linear(nn.Module):
    """Dense layer, weight (out, in) lecun-normal, bias zero."""

    def __init__(self, in_features, out_features, *, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty((out_features, in_features), dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features))
        if generator is not None:
            lecun_normal_(self.weight, generator)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class RubiksNet(nn.Module):
    """Video action recognition with learnable fractional shifts, inference.

    ``dtype`` is the compute dtype; parameters stay float32. ``max_shift``
    is the bound K on the integer part of the shifts that the fused
    executor's tap weights cover (see models/fused_infer.py).
    """

    def __init__(self, tier, num_classes, num_frames=8, variant="rubiks3d",
                 quantize=False, max_shift=4, dtype=torch.float32, *,
                 generator=None):
        super().__init__()
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r}")
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        width, repeats, use_se = TIERS[tier]
        if use_se:
            raise NotImplementedError(
                f"tier {tier!r} uses SE blocks, not ported yet (ROADMAP: "
                "K2/K3 with SE)")
        if variant != "rubiks3d":
            raise NotImplementedError(
                f"variant {variant!r} is not ported yet (ROADMAP: K2 with "
                "AQ, and P1 as a 2D shift)")
        self.tier, self.num_classes, self.num_frames = tier, num_classes, (
            num_frames)
        self.variant, self.quantize, self.max_shift = variant, quantize, (
            max_shift)
        self.dtype = dtype
        self.backbone = RubiksNetBackbone(width, repeats, quantize,
                                          generator=generator)
        self.new_fc = Linear(8 * width, num_classes, generator=generator)

    def head(self, x):
        """Last stage's (N, T, H, W, C) -> (N, num_classes): bn_last, ReLU,
        spatial mean, new_fc per frame, mean over frames (TSN consensus)."""
        return self.new_fc(self.backbone.pool(x)).mean(dim=1)

    def forward(self, video, plain=False):
        """video (N, T, H, W, 3) -> logits (N, num_classes) in the compute
        dtype. Shifts run through K1 on CUDA; ``plain=True`` runs every op
        as plain PyTorch (the reference route the kernels are held to)."""
        if video.ndim != 5 or video.shape[-1] != 3:
            raise ValueError(
                f"expected (N, T, H, W, 3), got {tuple(video.shape)}")
        feats = self.backbone(video.to(self.dtype), plain=plain)
        return self.new_fc(feats).mean(dim=1)


def from_ntchw(video):
    """Reference-layout (N, T, 3, H, W) video to (N, T, H, W, 3)."""
    return video.permute(0, 1, 3, 4, 2)


def create_rubiksnet(tier, num_classes, num_frames=8, variant="rubiks3d",
                     max_shift=4, quantize=False, device="cpu",
                     dtype=torch.float32, generator=None):
    """A randomly initialized RubiksNet in eval mode on ``device``.

    Weights are drawn on the CPU from ``generator`` (default: seed 0), so a
    seed gives the same model on every device. Init: He fan-out normal
    convs, shifts U(-1, 1), BN weight 1 and bias 0, lecun-normal new_fc.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = RubiksNet(tier, num_classes, num_frames, variant, quantize,
                      max_shift, dtype, generator=generator)
    return model.to(device).eval()
