"""TSN-style frame-folder video dataset.

Counterpart of ``rubiksnet_tpu/data/dataset.py`` (the reference's
rubiksnet/dataset/core.py) with the index samplers as pure deterministic
functions (seedable, testable) and without a DataLoader:
`RubiksDataset` yields numpy clips, and `batch_iterator` produces padded,
fixed-shape batches (the kernels' launch plans depend on the batch, so a
short last batch keeps the shape of the others).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image


@dataclass
class VideoRecord:
    """One line of a `path num_frames label` list file
    (dataset/core.py:328-343)."""

    path: str
    num_frames: int
    label: int


def parse_list_file(
    list_file: str,
    test_mode: bool = False,
    remove_missing: bool = False,
    halve_frame_counts: bool = False,
) -> List[VideoRecord]:
    """dataset/core.py:76-87: parse and drop videos with < 3 frames unless in
    pure test mode; `halve_frame_counts` reproduces the template-specific
    halving at core.py:84-86."""
    records = []
    with open(list_file) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 3:
                continue
            n = int(parts[1])
            if (not test_mode or remove_missing) and n < 3:
                continue
            if halve_frame_counts:
                n = int(n / 2)
            records.append(VideoRecord(parts[0], n, int(parts[2])))
    return records


# --------------------------------------------------------------- samplers
# All samplers return 1-based frame indices; with only_even_indices the
# dataset stores frames at even numbers (SSv2), handled per core.py:97-106.


def sample_train_indices(
    num_frames: int,
    num_segments: int,
    only_even: bool = True,
    new_length: int = 1,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Random-segment training sampler (dataset/core.py:89-164, normal
    path)."""
    rng = rng or np.random
    effective = num_frames // 2 if only_even else num_frames
    average_duration = (effective - new_length + 1) // num_segments
    if average_duration > 0:
        offsets = np.multiply(
            list(range(num_segments)), average_duration
        ) + rng.randint(average_duration, size=num_segments)
    elif effective > num_segments:
        offsets = np.sort(rng.randint(effective - new_length + 1, size=num_segments))
    else:
        offsets = np.zeros((num_segments,), dtype=np.int64)
    offsets = np.asarray(offsets)
    return (offsets + 1) * 2 if only_even else offsets + 1


def sample_dense_indices(
    num_frames: int,
    num_segments: int,
    only_even: bool = True,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """i3d-style dense sampler with a random start, used by BOTH the train
    and val paths (the reference duplicates identical code in
    dataset/core.py:95-116 and 167-188)."""
    rng = rng or np.random
    effective = num_frames // 2 if only_even else num_frames
    window = 32 if only_even else 64
    sample_pos = max(1, 1 + effective - window)
    t_stride = window // num_segments
    start_idx = 0 if sample_pos == 1 else rng.randint(0, sample_pos - 1)
    offsets = np.array(
        [(idx * t_stride + start_idx) % effective for idx in range(num_segments)]
    )
    return (offsets + 1) * 2 if only_even else offsets + 1


def sample_all_indices(
    num_frames: int,
    num_segments: int,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Contiguous-window sampler with a random start (dataset/core.py:118-125
    and 189-196; identical for train and val). Note the reference applies no
    even-index doubling on this path."""
    rng = rng or np.random
    sample_pos = max(1, 1 + num_frames - num_segments)
    start_idx = 0 if sample_pos == 1 else rng.randint(0, sample_pos - 1)
    offsets = np.array(
        [(idx + start_idx) % num_frames for idx in range(num_segments)]
    )
    return offsets + 1


def sample_val_indices(
    num_frames: int, num_segments: int, only_even: bool = True, new_length: int = 1
) -> np.ndarray:
    """Strided-center validation sampler (dataset/core.py:166-220, normal
    path)."""
    effective = num_frames // 2 if only_even else num_frames
    if effective > num_segments + new_length - 1:
        tick = (effective - new_length + 1) / float(num_segments)
        offsets = np.array(
            [int(tick / 2.0 + tick * x) for x in range(num_segments)]
        )
    else:
        offsets = np.zeros((num_segments,), dtype=np.int64)
    return (offsets + 1) * 2 if only_even else offsets + 1


def sample_test_indices(
    num_frames: int,
    num_segments: int,
    twice_sample: bool = False,
    dense_sample: bool = False,
    all_sample: bool = False,
    only_even: bool = True,
    new_length: int = 1,
) -> np.ndarray:
    """Test samplers (dataset/core.py:222-265).

    twice_sample: centered + left-aligned tick offsets -> 2 clips
    (core.py:246-254). NOTE the reference's twice/normal test samplers do NOT
    apply the even-index doubling — reproduced as-is.
    dense_sample: i3d-style 10 evenly spaced starts (core.py:223-245).
    """
    if dense_sample:
        if only_even:
            sample_pos = max(1, 1 + num_frames // 2 - 32)
            t_stride = 32 // num_segments
            start_list = np.linspace(0, sample_pos - 1, num=10, dtype=int)
            offsets = []
            for start_idx in start_list.tolist():
                offsets += [
                    (idx * t_stride + start_idx) % (num_frames // 2)
                    for idx in range(num_segments)
                ]
            return (np.array(offsets) + 1) * 2
        sample_pos = max(1, 1 + num_frames - 64)
        t_stride = 64 // num_segments
        start_list = np.linspace(0, sample_pos - 1, num=10, dtype=int)
        offsets = []
        for start_idx in start_list.tolist():
            offsets += [
                (idx * t_stride + start_idx) % num_frames
                for idx in range(num_segments)
            ]
        return np.array(offsets) + 1
    if twice_sample:
        tick = (num_frames - new_length + 1) / float(num_segments)
        offsets = np.array(
            [int(tick / 2.0 + tick * x) for x in range(num_segments)]
            + [int(tick * x) for x in range(num_segments)]
        )
        return offsets + 1
    if all_sample:
        return np.arange(num_frames) + 1
    tick = (num_frames - new_length + 1) / float(num_segments)
    offsets = np.array([int(tick / 2.0 + tick * x) for x in range(num_segments)])
    return offsets + 1


class RubiksDataset:
    """Frame-folder dataset yielding (clip_array, label).

    Mirrors rubiksnet/dataset/core.py:11-326 with numpy outputs. The
    transform receives a list of PIL images (one per sampled index, expanded
    by new_length with the same carry semantics as core.py:310-322) and
    should return a numpy array.
    """

    def __init__(
        self,
        root_path: str,
        list_file: str,
        num_segments: int = 8,
        new_length: int = 1,
        image_tmpl: str = "img_{:05d}.jpg",
        transform: Optional[Callable] = None,
        random_shift: bool = True,
        test_mode: bool = False,
        remove_missing: bool = False,
        dense_sample: bool = False,
        all_sample: bool = False,
        twice_sample: bool = False,
        only_even_indices: bool = True,
        seed: Optional[int] = None,
    ):
        self.root_path = root_path
        self.num_segments = num_segments
        self.new_length = new_length
        self.image_tmpl = image_tmpl
        self.transform = transform
        self.random_shift = random_shift
        self.test_mode = test_mode
        self.dense_sample = dense_sample
        self.all_sample = all_sample
        self.twice_sample = twice_sample
        self.only_even = only_even_indices
        self.rng = np.random.RandomState(seed) if seed is not None else np.random
        halve = image_tmpl == "{:06d}-{}_{:05d}.jpg"
        self.video_list = parse_list_file(
            list_file, test_mode=test_mode, remove_missing=remove_missing,
            halve_frame_counts=halve,
        )

    def __len__(self):
        return len(self.video_list)

    def _frame_path(self, record: VideoRecord, idx: int) -> str:
        if self.image_tmpl == "{:06d}-{}_{:05d}.jpg":
            file_name = self.image_tmpl.format(int(record.path), "x", idx)
            return os.path.join(
                self.root_path, "{:06d}".format(int(record.path)), file_name
            )
        return os.path.join(
            self.root_path, record.path, self.image_tmpl.format(idx)
        )

    def _load_image(self, record: VideoRecord, idx: int) -> Image.Image:
        try:
            return Image.open(self._frame_path(record, idx)).convert("RGB")
        except Exception:
            # degenerate retry of core.py:58-74: fall back to frame 2
            return Image.open(self._frame_path(record, 2)).convert("RGB")

    def _frame_size(self, record: VideoRecord, idx: int):
        """(w, h) of a frame from its header alone (PIL decodes lazily),
        with :meth:`_load_image`'s fall-back."""
        try:
            with Image.open(self._frame_path(record, idx)) as img:
                return img.size
        except Exception:
            with Image.open(self._frame_path(record, 2)) as img:
                return img.size

    def indices_for(self, record: VideoRecord) -> np.ndarray:
        if not self.test_mode:
            # dense/all take precedence over the normal train/val samplers and
            # are identical between them (dataset/core.py:95-125, 167-196).
            if self.dense_sample:
                return sample_dense_indices(
                    record.num_frames, self.num_segments, self.only_even,
                    rng=self.rng,
                )
            if self.all_sample:
                return sample_all_indices(
                    record.num_frames, self.num_segments, rng=self.rng
                )
            if self.random_shift:
                return sample_train_indices(
                    record.num_frames, self.num_segments, self.only_even,
                    self.new_length, rng=self.rng,
                )
            return sample_val_indices(
                record.num_frames, self.num_segments, self.only_even, self.new_length
            )
        return sample_test_indices(
            record.num_frames,
            self.num_segments,
            twice_sample=self.twice_sample,
            dense_sample=self.dense_sample,
            all_sample=self.all_sample,
            only_even=self.only_even,
            new_length=self.new_length,
        )

    def __getitem__(self, index: int):
        record = self.video_list[index]
        indices = self.indices_for(record)
        images = []
        for seg_ind in indices:
            p = int(seg_ind)
            for _ in range(self.new_length):
                images.append(self._load_image(record, p))
                if p < record.num_frames:
                    p += 1
        data = self.transform(images) if self.transform else images
        return data, record.label

    def skip(self, index: int) -> None:
        """Make the random draws of ``self[index]``, the sampler's and then
        the transform's, without decoding a frame: the transform (a
        ``Compose`` whose members have ``skip``) draws for the first
        frame's size, read from its header. A rank of a data group skips
        the other ranks' clips, so that its own get one process's draws."""
        record = self.video_list[index]
        indices = self.indices_for(record)
        if self.transform is not None:
            self.transform.skip(self._frame_size(record, int(indices[0])))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def batch_iterator(
    dataset: "RubiksDataset",
    batch_size: int,
    num_crops: int,
    num_frames: int,
    drop_remainder: bool = False,
    rank: int = 0,
    world: int = 1,
    skip: Optional[Callable[[int], None]] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (video, labels, valid) batches of one fixed shape.

    video: (B, num_crops, T, H, W, 3), keeping the dataset's dtype (float32
    for host-normalized clips, uint8 when normalization is deferred to the
    device); the transform output (num_crops * T, H, W, 3) is reshaped view
    by view, as the reference evaluator does. The final short batch is
    zero-padded, and `valid` marks its real entries.

    With ``world > 1`` each global batch of ``batch_size`` clips is split
    into ``world`` contiguous parts of B = batch_size / world rows, and
    only part ``rank`` is read (by index) and yielded: every rank yields
    as many batches, its part of the last one padded (possibly all
    padding). Where the dataset draws randomness per clip (a training
    sampler, random transforms), pass ``skip`` (``RubiksDataset.skip``):
    it is called, in index order, for every clip that this rank does not
    read, the dropped remainder's included, so that the rank's clips get
    one process's draws.
    """
    if world > 1:
        yield from _rank_batches(dataset, batch_size, num_crops, num_frames,
                                 drop_remainder, rank, world, skip)
        return
    buf_v, buf_l = [], []

    def emit(valid_n):
        video = np.stack(buf_v)
        labels = np.asarray(buf_l, np.int32)
        valid = np.zeros((len(buf_v),), np.float32)
        valid[:valid_n] = 1.0
        return video, labels, valid

    for clip, label in dataset:
        buf_v.append(_views(clip, num_crops, num_frames))
        buf_l.append(label)
        if len(buf_v) == batch_size:
            yield emit(batch_size)
            buf_v, buf_l = [], []
    if buf_v and not drop_remainder:
        n = len(buf_v)
        pad = batch_size - n
        buf_v.extend([np.zeros_like(buf_v[0])] * pad)
        buf_l.extend([0] * pad)
        yield emit(n)


def _views(clip, num_crops, num_frames):
    clip = np.asarray(clip)
    if clip.dtype != np.uint8:
        clip = clip.astype(np.float32, copy=False)
    total, h, w, ch = clip.shape
    assert total == num_crops * num_frames, (
        f"transform produced {total} frames, expected {num_crops}x{num_frames}"
    )
    return clip.reshape(num_crops, num_frames, h, w, ch)


def _rank_batches(dataset, batch_size, num_crops, num_frames,
                  drop_remainder, rank, world, skip):
    """:func:`batch_iterator`'s batches of one rank of ``world``."""
    if batch_size % world:
        raise ValueError(f"a batch of {batch_size} clips does not divide "
                         f"over {world} ranks")
    local = batch_size // world
    n = len(dataset)
    stop = n - n % batch_size if drop_remainder else n
    template = None
    for start in range(0, stop, batch_size):
        lo = start + rank * local
        rows = []
        for i in range(start, min(start + batch_size, n)):
            if lo <= i < lo + local:
                rows.append(dataset[i])
            elif skip is not None:
                skip(i)
        views = [_views(clip, num_crops, num_frames) for clip, _ in rows]
        if template is None:
            template = np.zeros_like(
                views[0] if views else _views(dataset[start][0], num_crops,
                                              num_frames))
        valid = np.zeros((local,), np.float32)
        valid[:len(rows)] = 1.0
        labels = np.zeros((local,), np.int32)
        labels[:len(rows)] = [label for _, label in rows]
        views += [template] * (local - len(rows))
        yield np.stack(views), labels, valid
    if skip is not None:
        for i in range(stop, n):
            skip(i)
