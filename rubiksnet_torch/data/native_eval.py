"""Native-loader eval dataset: the C++ decode/resize/crop/normalize pipeline
driving the standard eval protocols.

Counterpart of ``rubiksnet_tpu/data/native_eval.py``. Python computes the
sampler indices and the exact crop offsets (reading only JPEG headers for
image sizes — cheap), then hands frame paths + offsets to the threaded
native loader (``csrc/rubiks_loader.cpp``), which produces channel-last
clips directly. This replaces the PIL
decode + crop + normalize chain of the reference's DataLoader workers
(rubiksnet/transforms.py) for the two eval protocols:

  1-clip: shorter-side scale + center crop (GroupScale + GroupCenterCrop)
  2-clip: twice_sample x 3 full-res crops (GroupFullResSample offsets,
          transforms.py:164-167)
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image

from . import native_loader
from .dataset import RubiksDataset


def _scaled_size(w: int, h: int, scale: int) -> Tuple[int, int]:
    """Shorter-side resize target dims (matches GroupScale / the native
    resizer)."""
    if (w <= h and w == scale) or (h <= w and h == scale):
        return w, h
    if w < h:
        return scale, int(scale * h / w)
    return int(scale * w / h), scale


def full_res_offsets(w: int, h: int, crop: int) -> List[Tuple[int, int]]:
    """The 3 horizontal crop origins of GroupFullResSample
    (transforms.py:164-167): left, right, center at vertical center."""
    w_step = (w - crop) // 4
    h_step = (h - crop) // 4
    return [(0, 2 * h_step), (4 * w_step, 2 * h_step), (2 * w_step, 2 * h_step)]


def center_offset(w: int, h: int, crop: int) -> Tuple[int, int]:
    """PIL-style center crop origin (round-half-up, matching
    torchvision CenterCrop)."""
    return int(round((w - crop) / 2.0)), int(round((h - crop) / 2.0))


class NativeEvalDataset:
    """Iterates (clip_array, label) using the native loader.

    Wraps a transform-less RubiksDataset for list parsing / samplers / frame
    paths; produces (num_views * T, crop, crop, 3) float32 clips matching the
    PIL pipeline to JPEG-decode rounding (±1/255 per pixel).
    """

    def __init__(
        self,
        dataset: RubiksDataset,
        scale_size: int,
        crop_size: int,
        mean: Sequence[float],
        std: Sequence[float],
        two_clips: bool = False,
        num_threads=None,
        out_dtype: str = "float32",
    ):
        if dataset.transform is not None:
            raise ValueError("pass a transform-less dataset")
        if out_dtype not in ("float32", "uint8"):
            raise ValueError(f"out_dtype {out_dtype!r}: float32 or uint8")
        native_loader.load_library()  # raises where it cannot be built
        self.ds = dataset
        self.scale_size = scale_size
        self.crop_size = crop_size
        self.mean = tuple(mean)
        self.std = tuple(std)
        self.two_clips = two_clips
        self.num_threads = num_threads
        # "uint8": raw pixels, normalization deferred to the device (the
        # eval step) — 4x fewer host->device bytes than f32.
        self.out_dtype = out_dtype

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, index: int):
        record = self.ds.video_list[index]
        indices = self.ds.indices_for(record)
        paths = [self.ds._frame_path(record, int(i)) for i in indices]

        # image size from the JPEG header only (no decode)
        with Image.open(paths[0]) as im:
            w0, h0 = im.size
        sw, sh = _scaled_size(w0, h0, self.scale_size)

        raw = self.out_dtype == "uint8"
        if self.two_clips:
            # decode each frame once, emit all 3 GroupFullResSample crops
            # (crop-major output order = the PIL pipeline's view order)
            offsets = full_res_offsets(sw, sh, self.crop_size)
            if raw:
                clip = native_loader.load_frames_multicrop_u8(
                    paths, self.scale_size, self.crop_size,
                    crop_offsets=offsets, num_threads=self.num_threads,
                )
            else:
                clip = native_loader.load_frames_multicrop(
                    paths,
                    self.scale_size,
                    self.crop_size,
                    self.mean,
                    self.std,
                    crop_offsets=offsets,
                    num_threads=self.num_threads,
                )
        else:
            ox, oy = center_offset(sw, sh, self.crop_size)
            if raw:
                clip = native_loader.load_frames_u8(
                    paths, self.scale_size, self.crop_size,
                    crop_offsets=[(ox, oy)] * len(paths),
                    num_threads=self.num_threads,
                )
            else:
                clip = native_loader.load_frames(
                    paths,
                    self.scale_size,
                    self.crop_size,
                    self.mean,
                    self.std,
                    crop_offsets=[(ox, oy)] * len(paths),
                    num_threads=self.num_threads,
                )
        return clip, record.label

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
