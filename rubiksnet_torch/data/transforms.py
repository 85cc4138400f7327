"""Clip-level (group) transforms on numpy and PIL.

Counterpart of ``rubiksnet_tpu/data/transforms.py``: the same 13-transform
surface as the reference's rubiksnet/transforms.py, with another
architecture: frames are stacked into ONE channel-last uint8 array
(T, H, W, C) as early as possible, crop geometry is expressed as pure offset
tables (`fix_crop_anchors`, `horizontal_3crop_offsets`), and every multi-view
eval crop (center / 3-crop / 5-crop / flips) is array slicing on that clip —
no per-frame PIL crop loops. PIL is kept only where its anti-aliased bilinear
resampling is needed for eval parity (shorter-side scale, and the fused
crop+resize of the training crops via ``Image.resize(..., box=...)``).

The reference pipeline's CPU hot spot was the HW(T*C) stack + HWC->CHW
transpose (its transforms.py:361 comments "80% of the loading time");
channel-last stacking eliminates the transpose entirely.

Parity notes (geometry must match bit-exactly for eval):
  * 3-crop offsets: left/right/center on the (image-crop)/4 step grid,
    matching rubiksnet/transforms.py:164-167.
  * 13 fixed multi-scale anchors: the 5 corner/center anchors plus 8 edge /
    quarter anchors, matching transforms.py:256-276.
  * crop-size snapping: candidate sizes within 3px of the target snap to it,
    and (w, h) pairs are limited to |scale_i - scale_j| <= max_distort
    (transforms.py:215-233).
"""

from __future__ import annotations

import math
import numbers
import random

import numpy as np
from PIL import Image

__all__ = [
    "GroupRandomCrop",
    "GroupCenterCrop",
    "GroupRandomHorizontalFlip",
    "GroupNormalize",
    "GroupScale",
    "GroupOverSample",
    "GroupFullResSample",
    "GroupMultiScaleCrop",
    "GroupRandomSizedCrop",
    "Stack",
    "ToClipArray",
    "IdentityTransform",
    "Compose",
]


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


# --------------------------------------------------------------- primitives


def as_clip_array(frames) -> np.ndarray:
    """List of PIL images (or an already-stacked array) -> (T, H, W, C) uint8.

    Grayscale frames get an explicit channel axis so flow clips keep their
    per-frame structure."""
    if isinstance(frames, np.ndarray):
        return frames
    arrs = []
    for f in frames:
        a = np.asarray(f)
        arrs.append(a[:, :, None] if a.ndim == 2 else a)
    return np.stack(arrs, axis=0)


def _clip_size(clip: np.ndarray):
    """(width, height) of a stacked clip."""
    return clip.shape[2], clip.shape[1]


def _flip_lr(clip: np.ndarray, flow_invert: bool) -> np.ndarray:
    """Horizontal flip; for flow clips (single channel, x/y interleaved by
    frame) the x-component frames (even indices) are inverted, mirroring the
    reference's ImageOps.invert on mode-'L' even frames."""
    out = clip[:, :, ::-1]
    if flow_invert and clip.shape[-1] == 1:
        out = out.copy()
        out[0::2] = 255 - out[0::2]
    return out


def crop_view(clip: np.ndarray, ow: int, oh: int, cw: int, ch: int) -> np.ndarray:
    """One crop as a zero-copy view of the stacked clip."""
    return clip[:, oh : oh + ch, ow : ow + cw]


def multi_view_crop(clip, offsets, cw, ch, flip: bool) -> np.ndarray:
    """All views of an eval-time multi-crop in one array.

    For each offset: the crop, then (when flip is on) its mirror — the same
    view ordering the reference produces, so downstream consensus averaging
    sees identical clips."""
    is_flow = clip.shape[-1] == 1
    views = []
    for ow, oh in offsets:
        v = crop_view(clip, ow, oh, cw, ch)
        views.append(v)
        if flip:
            views.append(_flip_lr(v, is_flow))
    return np.concatenate(views, axis=0)


def fix_crop_anchors(image_w, image_h, crop_w, crop_h, extended=True):
    """Canonical fixed-crop anchor table on the quarter-step grid.

    The 5 base anchors are the 4 corners + center; ``extended`` adds the 4
    edge midpoints and 4 quarter positions for 13 total. Equivalent offset
    set to the reference's fill_fix_offset (transforms.py:256-276)."""
    sw = (image_w - crop_w) // 4
    sh = (image_h - crop_h) // 4
    anchors = [(0, 0), (4, 0), (0, 4), (4, 4), (2, 2)]
    if extended:
        anchors += [(0, 2), (4, 2), (2, 4), (2, 0), (1, 1), (3, 1), (1, 3), (3, 3)]
    return [(ax * sw, ay * sh) for ax, ay in anchors]


def horizontal_3crop_offsets(image_w, image_h, crop_w, crop_h):
    """Left / right / center at vertical center — the 2-clip eval protocol's
    spatial views (geometry of reference transforms.py:164-167)."""
    sw = (image_w - crop_w) // 4
    sh = (image_h - crop_h) // 4
    return [(0, 2 * sh), (4 * sw, 2 * sh), (2 * sw, 2 * sh)]


def _pair(size):
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    return int(size[0]), int(size[1])


def _scale_shorter_side(img, size, interpolation=Image.BILINEAR):
    """Shorter-side resize, matching torchvision.transforms.Resize(int)."""
    w, h = img.size
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        return img.resize((size, int(size * h / w)), interpolation)
    return img.resize((int(size * w / h), size), interpolation)


# ------------------------------------------------------------- PIL stage


class GroupScale:
    """Shorter-side bilinear rescale on PIL frames (anti-aliased resampling
    is load-bearing for eval parity, so this stage stays PIL)."""

    def __init__(self, size, interpolation=Image.BILINEAR):
        self.size = size
        self.interpolation = interpolation

    def __call__(self, img_group):
        return [
            _scale_shorter_side(img, self.size, self.interpolation)
            for img in img_group
        ]


# ------------------------------------------------------------ array stage


class GroupCenterCrop:
    """Center crop via array slicing (round-half-up center, matching
    torchvision CenterCrop)."""

    def __init__(self, size):
        self.size = _pair(size)

    def __call__(self, frames):
        clip = as_clip_array(frames)
        th, tw = self.size
        w, h = _clip_size(clip)
        ow = int(round((w - tw) / 2.0))
        oh = int(round((h - th) / 2.0))
        return crop_view(clip, ow, oh, tw, th)


class GroupRandomCrop:
    """One random crop shared by all frames of the clip."""

    def __init__(self, size):
        self.size = _pair(size)

    def __call__(self, frames):
        clip = as_clip_array(frames)
        th, tw = self.size
        w, h = _clip_size(clip)
        ow = random.randint(0, w - tw)
        oh = random.randint(0, h - th)
        return crop_view(clip, ow, oh, tw, th)


class GroupRandomHorizontalFlip:
    """50% horizontal flip of the whole clip (flow x-frames inverted)."""

    def __init__(self, is_flow=False):
        self.is_flow = is_flow

    def __call__(self, frames):
        clip = as_clip_array(frames)
        if random.random() < 0.5:
            return _flip_lr(clip, self.is_flow)
        return clip


class GroupFullResSample:
    """3 horizontal crops (left/right/center) ± mirrors — the 2-clip eval
    protocol's spatial views, as one vectorized multi-crop."""

    def __init__(self, crop_size, scale_size=None, flip=True):
        self.crop_size = _pair(crop_size)
        self.scale_worker = GroupScale(scale_size) if scale_size is not None else None
        self.flip = flip

    def __call__(self, img_group):
        if self.scale_worker is not None:
            img_group = self.scale_worker(img_group)
        clip = as_clip_array(img_group)
        cw, ch = self.crop_size
        w, h = _clip_size(clip)
        return multi_view_crop(
            clip, horizontal_3crop_offsets(w, h, cw, ch), cw, ch, self.flip
        )


class GroupOverSample:
    """Classic 5-crop (+ mirrors) oversampling as one vectorized multi-crop."""

    def __init__(self, crop_size, scale_size=None, flip=True):
        self.crop_size = _pair(crop_size)
        self.scale_worker = GroupScale(scale_size) if scale_size is not None else None
        self.flip = flip

    def __call__(self, img_group):
        if self.scale_worker is not None:
            img_group = self.scale_worker(img_group)
        clip = as_clip_array(img_group)
        cw, ch = self.crop_size
        w, h = _clip_size(clip)
        offsets = fix_crop_anchors(w, h, cw, ch, extended=False)
        return multi_view_crop(clip, offsets, cw, ch, self.flip)


class GroupMultiScaleCrop:
    """Training crop: pick a jittered crop size from the scale table and one
    of the 13 fixed anchors, then crop + bilinear-resize each frame.

    (Crop and resize stay two explicit PIL steps: PIL's fused
    ``resize(box=...)`` samples across the box border and diverges from the
    reference's crop-then-resize at the edges.)"""

    def __init__(
        self, input_size, scales=None, max_distort=1, fix_crop=True, more_fix_crop=True
    ):
        self.scales = list(scales) if scales is not None else [1, 0.875, 0.75, 0.66]
        self.max_distort = max_distort
        self.fix_crop = fix_crop
        self.more_fix_crop = more_fix_crop
        self.input_size = _pair(input_size)
        self.interpolation = Image.BILINEAR

    def _snap(self, candidate, target):
        """Candidate sizes within 3px of the network input snap to it."""
        return target if abs(candidate - target) < 3 else candidate

    def _choose_geometry(self, image_w, image_h):
        """(crop_w, crop_h, offset_w, offset_h) sampled per the reference's
        distribution: scale pair limited by max_distort, anchor from the
        fixed table (or uniform when fix_crop is off)."""
        base = min(image_w, image_h)
        tw, th = self.input_size
        ws = [self._snap(int(base * s), tw) for s in self.scales]
        hs = [self._snap(int(base * s), th) for s in self.scales]
        candidates = [
            (w, h)
            for i, h in enumerate(hs)
            for j, w in enumerate(ws)
            if abs(i - j) <= self.max_distort
        ]
        cw, ch = random.choice(candidates)
        if self.fix_crop:
            anchors = fix_crop_anchors(
                image_w, image_h, cw, ch, extended=self.more_fix_crop
            )
            ow, oh = random.choice(anchors)
        else:
            ow = random.randint(0, image_w - cw)
            oh = random.randint(0, image_h - ch)
        return cw, ch, ow, oh

    def __call__(self, img_group):
        w, h = img_group[0].size
        cw, ch, ow, oh = self._choose_geometry(w, h)
        return as_clip_array(
            [
                img.crop((ow, oh, ow + cw, oh + ch)).resize(
                    self.input_size, self.interpolation
                )
                for img in img_group
            ]
        )


class GroupRandomSizedCrop:
    """Inception-style area/aspect jittered crop + resize per frame; falls
    back to scale + random crop when no geometry fits."""

    def __init__(self, size, interpolation=Image.BILINEAR):
        self.size = _pair(size)
        self.interpolation = interpolation

    def _try_geometry(self, image_w, image_h):
        for _ in range(10):
            target_area = random.uniform(0.08, 1.0) * image_w * image_h
            aspect = random.uniform(3.0 / 4, 4.0 / 3)
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if random.random() < 0.5:
                w, h = h, w
            if w <= image_w and h <= image_h:
                return (
                    w,
                    h,
                    random.randint(0, image_w - w),
                    random.randint(0, image_h - h),
                )
        return None

    def __call__(self, img_group):
        geom = self._try_geometry(*img_group[0].size)
        if geom is None:
            fallback = Compose(
                [GroupScale(self.size[0], self.interpolation),
                 GroupRandomCrop(self.size)]
            )
            return fallback(img_group)
        w, h, ow, oh = geom
        return as_clip_array(
            [
                img.crop((ow, oh, ow + w, oh + h)).resize(
                    self.size, self.interpolation
                )
                for img in img_group
            ]
        )


# --------------------------------------------------------------- terminal


class GroupNormalize:
    """Per-channel normalization on a channel-last float clip."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, clip):
        return (clip - self.mean) / self.std


class Stack:
    """Frames -> channel-last (n_frames, H, W, C) uint8 array.

    With the array-stage transforms above this is usually a passthrough; it
    stacks only when handed a raw PIL list. ``roll`` swaps RGB->BGR."""

    def __init__(self, roll=False):
        self.roll = roll

    def __call__(self, frames):
        clip = as_clip_array(frames)
        return clip[:, :, :, ::-1] if self.roll else clip


class ToClipArray:
    """uint8 (n, H, W, C) -> float32 in [0, 1]."""

    def __init__(self, div=True):
        self.div = div

    def __call__(self, arr):
        arr = np.asarray(arr, np.float32)
        return arr / 255.0 if self.div else arr


class IdentityTransform:
    def __call__(self, data):
        return data
