"""The evaluator cell's inputs and their plain reading.

* :func:`write_videos`: SSv2-like frame folders of JPEGs and their list
  file, from the seed (a copy of the port's
  ``scripts/eval_throughput.py::write_video``: a coarse random image
  upscaled, each frame jittered, quality 87).
* :func:`test_indices`: the evaluator's 1-clip frame sampler (the
  centred ticks of TSN's test mode, 1-based).
* :func:`resize_crop`: the shorter side scaled with Pillow's BILINEAR
  support as the port's native and device loaders compute it (a frozen
  copy of the port's ``data/device_loader.py``: ``triangle_coeffs``,
  ``resized_size`` and ``plain_resize_crop``'s two float64 passes, the
  horizontal one rounded to float32), then the centre crop.
* :func:`decode`: Pillow's decode of the frames to RGB.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np

TMPL = "{:05d}.jpg"


def write_videos(root, rng, count, size, frames_range, quality,
                 num_classes, repeats):
    """``count`` videos ``vid00000/00001.jpg ...`` of ``size`` (w, h) with
    ``frames_range`` (lo, hi) frames each, and ``root/val.txt`` listing
    them ``repeats`` times over. ``rng``: a ``numpy.random.Generator``.
    Returns (the list file, [(folder, frames, label)])."""
    from PIL import Image

    videos = []
    for vi in range(count):
        name = f"vid{vi:05d}"
        folder = os.path.join(root, name)
        os.makedirs(folder)
        frames = int(rng.integers(frames_range[0], frames_range[1] + 1))
        base = rng.integers(0, 200, (8, 11, 3)).astype(np.uint8)
        img = np.asarray(Image.fromarray(base).resize(size, Image.BILINEAR))
        for f in range(1, frames + 1):
            jitter = rng.integers(-10, 10, (1, 1, 3))
            frame = np.clip(img.astype(np.int16) + jitter, 0, 255)
            Image.fromarray(frame.astype(np.uint8)).save(
                os.path.join(folder, TMPL.format(f)), quality=quality)
        videos.append((name, frames, vi % num_classes))
    list_file = os.path.join(root, "val.txt")
    with open(list_file, "w") as f:
        for _ in range(repeats):
            f.write("".join(f"{n} {k} {c}\n" for n, k, c in videos))
    return list_file, videos


def test_indices(num_frames, segments):
    """1-based frame numbers of the 1-clip protocol: ``segments`` ticks of
    ``num_frames / segments``, each at its middle."""
    tick = num_frames / float(segments)
    return [int(tick / 2.0 + tick * x) + 1 for x in range(segments)]


def decode(paths):
    """The frames at ``paths`` as RGB uint8 arrays, by Pillow."""
    from PIL import Image

    out = []
    for p in paths:
        with Image.open(p) as im:
            out.append(np.asarray(im.convert("RGB")))
    return out


@functools.lru_cache(maxsize=None)
def triangle_coeffs(in_size, out_size):
    """(first tap, tap count, (out, ksize) float64 weights) of one axis:
    Pillow's BILINEAR support scaled by the downscale factor, each row
    normalized by its own sum, summed in tap order."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    lo = np.zeros(out_size, np.int64)
    counts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = int(max(center - support + 0.5, 0.0))
        xmax = int(min(center + support + 0.5, float(in_size))) - xmin
        row, ww = [], 0.0
        for x in range(xmax):
            arg = (x + xmin - center + 0.5) * ss
            weight = -arg if arg < 0 else arg
            weight = 1.0 - weight if weight < 1.0 else 0.0
            row.append(weight)
            ww += weight
        if ww != 0.0:
            row = [w / ww for w in row]
        weights[xx, :xmax] = row
        lo[xx], counts[xx] = xmin, xmax
    return lo, counts, weights


def resized_size(w, h, scale):
    """The shorter side scaled to ``scale``, the longer in proportion
    (truncated); unchanged where the shorter side is already ``scale``."""
    if min(w, h) == scale:
        return w, h
    if w < h:
        return scale, int(scale * h / w)
    return int(scale * w / h), scale


def _axis_pass(x, in_size, out_size, dim):
    import torch

    lo, _, weights = triangle_coeffs(in_size, out_size)
    lo = torch.from_numpy(lo).to(x.device)
    wts = torch.from_numpy(weights).to(x.device)
    shape = [1] * x.ndim
    shape[dim] = -1
    acc = None
    for j in range(weights.shape[1]):
        idx = torch.clamp(lo + j, max=in_size - 1)
        term = wts[:, j].reshape(shape) * x.index_select(dim, idx)
        acc = term if acc is None else acc + term
    return acc


def resize_crop(frames, scale, crop):
    """(N, H, W, 3) uint8 frames of one size -> (N, crop, crop, 3) uint8:
    resized (horizontal pass in float64 rounded to float32, then the
    vertical pass, plus 0.5, truncated, clamped) and centre-cropped."""
    import torch

    n, h, w, _ = frames.shape
    rw, rh = resized_size(w, h, scale)
    img = frames
    if (rw, rh) != (w, h):
        tmp = _axis_pass(frames.double(), w, rw, 2).float().double()
        acc = _axis_pass(tmp, h, rh, 1)
        img = torch.clamp(torch.trunc(acc + 0.5), 0, 255).to(torch.uint8)
    x0, y0 = (rw - crop) // 2, (rh - crop) // 2
    return img[:, y0:y0 + crop, x0:x0 + crop]
