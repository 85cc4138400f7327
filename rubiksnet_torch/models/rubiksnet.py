"""RubiksNet model: backbone, ``new_fc`` head and the TSN mean over frames.

Counterpart of ``rubiksnet_tpu/models/rubiksnet.py``. Input is channel-last
normalized RGB video (N, T, H, W, 3); :func:`from_ntchw` converts the
reference's (N, T, 3, H, W).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.backbone import VARIANTS, RubiksNetBackbone
from ..nn.layers import lecun_normal_
from ..parallel.mesh import column_parallel
from ..parallel.temporal import time_mean

TIERS = {
    # tier -> (width, repeats, use_se)
    "tiny": (54, (3, 4, 6, 3), False),
    "small": (72, (3, 4, 6, 3), True),
    "medium": (72, (3, 4, 23, 3), False),
    "large": (72, (3, 8, 36, 3), False),
}

# ImageNet normalization of the input frames and the crop the models are
# trained and evaluated at (the reference's models.py:108-109).
INPUT_MEAN = (0.485, 0.456, 0.406)
INPUT_STD = (0.229, 0.224, 0.225)
INPUT_SIZE = 224


class Linear(nn.Module):
    """Dense layer, weight (out, in) lecun-normal, bias zero. Under tensor
    parallelism the weight's output rows are sharded as
    ``nn.backbone.Conv1x1``'s and the replicated bias is added after the
    gather."""

    shard = None  # this rank's output rows, set by parallel.shard_params

    def __init__(self, in_features, out_features, *, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty((out_features, in_features), dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features))
        if generator is not None:
            lecun_normal_(self.weight, generator)

    def forward(self, x):
        if self.shard is not None:
            y = column_parallel(
                self.shard, x, lambda v: F.linear(v, self.weight.to(v.dtype)))
            return y + self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class RubiksNet(nn.Module):
    """Video action recognition with learnable fractional shifts.

    Train and eval run the same modules; train mode normalizes with batch
    statistics and updates the running ones (``nn.backbone.BN``), and the
    shifts carry the reference's normalized gradient. ``dtype`` is the
    compute dtype; parameters stay float32. ``max_shift`` is the bound K on
    the integer part of the shifts that the fused inference executor's tap
    weights cover (see models/fused_infer.py); the module path takes any
    shift.
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
        self.tier, self.num_classes, self.num_frames = tier, num_classes, (
            num_frames)
        self.variant, self.quantize, self.max_shift = variant, quantize, (
            max_shift)
        self.dtype = dtype
        self.backbone = RubiksNetBackbone(width, repeats, quantize, variant,
                                          use_se, generator=generator)
        self.new_fc = Linear(8 * width, num_classes, generator=generator)

    @property
    def feature_dim(self):
        """Width of the per-frame features the head classifies."""
        return 8 * TIERS[self.tier][0]

    @property
    def crop_size(self):
        return INPUT_SIZE

    @property
    def scale_size(self):
        """The short side frames are resized to before the crop."""
        return INPUT_SIZE * 256 // 224

    def replace_new_fc(self, num_classes, generator=None):
        """A fresh classification head of ``num_classes`` outputs (lecun-
        normal weight drawn on the CPU from ``generator``, default seed 0;
        zero bias), in place, on the old head's device. Returns self."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        old = self.new_fc.weight
        head = Linear(old.shape[1], num_classes, generator=generator)
        self.new_fc = head.to(old.device)
        self.num_classes = num_classes
        return self

    def head(self, x):
        """Last stage's (N, T, H, W, C) -> (N, num_classes): bn_last, ReLU,
        spatial mean, new_fc per frame, mean over frames (TSN consensus;
        under a time group over the whole clip, ``parallel.time_mean``)."""
        return time_mean(self.new_fc(self.backbone.pool(x)))

    def forward(self, video, plain=False):
        """video (N, T, H, W, 3) -> logits (N, num_classes) in the compute
        dtype. Shifts run through K1 on CUDA (and their gradients through
        K1-inverse and K4); ``plain=True`` runs every op as plain PyTorch
        (the reference route the kernels are held to)."""
        if video.ndim != 5 or video.shape[-1] != 3:
            raise ValueError(
                f"expected (N, T, H, W, 3), got {tuple(video.shape)}")
        feats = self.backbone(video.to(self.dtype), plain=plain)
        return time_mean(self.new_fc(feats))


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the CUDA card, and raises
    where CUDA is not available (the CPU is never a silent default)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: rubiksnet_torch builds its models on the card "
            "by default; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def from_ntchw(video):
    """Reference-layout (N, T, 3, H, W) video to (N, T, H, W, 3)."""
    return video.permute(0, 1, 3, 4, 2)


def create_rubiksnet(tier, num_classes, num_frames=8, variant="rubiks3d",
                     max_shift=4, quantize=False, device=None,
                     dtype=torch.float32, generator=None):
    """A randomly initialized RubiksNet in eval mode on ``device``.

    ``device=None`` is the CUDA card and raises where there is none; pass
    ``device="cpu"`` to run on the CPU (the kernels' plain versions).
    Weights are drawn on the CPU from ``generator`` (default: seed 0), so a
    seed gives the same model on every device. Init: He fan-out normal
    convs, shifts U(-1, 1), attention weights U[0, 1), BN weight 1 and bias
    0, lecun-normal SE and new_fc weights.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = RubiksNet(tier, num_classes, num_frames, variant, quantize,
                      max_shift, dtype, generator=generator)
    return model.to(device).eval()
