"""The evaluation protocols on the device loader: files read on the host,
decoded, resized and cropped on the card, one batch at a time.

Counterpart of ``native_eval.py`` on a machine without libjpeg. The
:class:`DeviceEvalDataset` gives, per video, what the native dataset hands
its C++ loader (the sampler's frame paths, the crop origins of the protocol,
computed from the first frame's header by ``native_eval``'s own helpers, and
the label); :func:`device_batches_from_files` turns a batch of those into
one :class:`~.device.DeviceBatch`: the batch's files read on the host, then
one ``decode_batch`` and one ``resize_crop`` (``device_loader.py``) for all
its frames, on a side stream, the rows, labels, ``valid`` mask and padding
of ``device_batches(batch_iterator(...))`` over the native dataset.

  1-clip: shorter-side scale + center crop, (B, 1, T, H, W, 3)
  2-clip: twice_sample x 3 full-res crops, (B, 6, T, H, W, 3), each video's
          frames crop-major as ``rl_load_frames_mc_u8`` writes them
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple

import numpy as np
import torch
from PIL import Image

from . import device_loader
from .dataset import RubiksDataset
from .device import DeviceBatch
from .native_eval import _scaled_size, center_offset, full_res_offsets


class DeviceEvalDataset:
    """Per video: (frame paths, crop origins, label) for the device loader.

    Wraps a transform-less RubiksDataset for the list, the samplers and the
    frame paths; its clips, from :func:`device_batches_from_files`, are
    uint8 (views, T, crop, crop, 3), normalized later on the device."""

    def __init__(self, dataset: RubiksDataset, scale_size: int,
                 crop_size: int, two_clips: bool = False):
        if dataset.transform is not None:
            raise ValueError("pass a transform-less dataset")
        self.ds = dataset
        self.scale_size = scale_size
        self.crop_size = crop_size
        self.two_clips = two_clips

    def __len__(self):
        return len(self.ds)

    def item(self, index: int) -> Tuple[List[str], List[Tuple[int, int]],
                                        int]:
        """The video's frame paths, its crops' (x, y) origins in resized
        coordinates (1, or the 3 of GroupFullResSample), and its label."""
        record = self.ds.video_list[index]
        indices = self.ds.indices_for(record)
        paths = [self.ds._frame_path(record, int(i)) for i in indices]
        with Image.open(paths[0]) as im:  # the header only
            w0, h0 = im.size
        sw, sh = _scaled_size(w0, h0, self.scale_size)
        if self.two_clips:
            origins = full_res_offsets(sw, sh, self.crop_size)
        else:
            origins = [center_offset(sw, sh, self.crop_size)]
        return paths, origins, record.label


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def device_batches_from_files(dataset: DeviceEvalDataset, batch_size: int,
                              num_views: int, frames: int, rank: int = 0,
                              world: int = 1,
                              device="cuda") -> Iterator[DeviceBatch]:
    """:class:`DeviceBatch` es of ``dataset``, the rows
    ``device_batches(batch_iterator(native dataset, batch_size, num_views,
    frames, rank=rank, world=world), device)`` yields: video (B, num_views,
    frames, crop, crop, 3) uint8 with B = batch_size / world, this rank's
    contiguous rows of each global batch, the short batch zero-padded and
    ``valid`` marking its real rows, labels int32.

    On the card the batch's work runs on a side stream, and the batch's
    event is recorded there (``DeviceBatch.take`` makes the consumer wait on
    it); run it inside the prefetch thread, which this generator points at
    ``device`` first (the calling thread's card where ``device`` names
    none). On the CPU the plain versions run."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if world > 1 and batch_size % world:
        raise ValueError(f"a batch of {batch_size} clips does not divide "
                         f"over {world} ranks")
    return _batches(dataset, batch_size // world, batch_size, num_views,
                    frames, rank, device)


def _batches(dataset, local, batch_size, num_views, frames, rank, device):
    """:func:`device_batches_from_files`' batches, ``local`` rows each."""
    crop, scale = dataset.crop_size, dataset.scale_size
    stream = None
    if device.type == "cuda":
        torch.cuda.set_device(device)
        stream = torch.cuda.Stream(device)
    n = len(dataset)
    for start in range(0, n, batch_size):
        lo = start + rank * local
        rows = [dataset.item(i)
                for i in range(lo, min(lo + local, start + batch_size, n))]
        labels = np.zeros((local,), np.int32)
        labels[:len(rows)] = [label for _, _, label in rows]
        valid = np.zeros((local,), np.float32)
        valid[:len(rows)] = 1.0
        blobs, origins = [], []
        for paths, crops, _ in rows:
            if len(crops) * len(paths) != num_views * frames:
                raise ValueError(
                    f"{len(crops)} crops of {len(paths)} frames are not "
                    f"{num_views} views of {frames}")
            blobs += [_read(p) for p in paths]
            origins += [crops] * len(paths)
        group = len(rows[0][0]) if rows else 1
        shape = (local, num_views, frames, crop, crop, 3)
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            video = torch.empty(shape, dtype=torch.uint8, device=device)
            if rows:
                rgb, sizes = device_loader.decode_batch(
                    blobs, device,
                    None if stream is None else stream.cuda_stream)
                device_loader.resize_crop(
                    rgb, sizes, scale, crop, origins, group=group,
                    out=video[:len(rows)].view(-1, crop, crop, 3))
            video[len(rows):].zero_()
            dev_labels = torch.from_numpy(labels).to(device)
            ready = None
            if stream is not None:
                ready = torch.cuda.Event()
                ready.record(stream)
        yield DeviceBatch(video, dev_labels, valid, ready)
