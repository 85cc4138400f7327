"""The port's data path (rubiksnet_torch.data) against the JAX package's
(rubiksnet_tpu.data) on the CPU: every sampler in every mode and seed, the
13 Group* transforms under the same ``random.seed``, the dataset (list
parsing, sampling, the frame-2 retry, the SSv2 ``{:06d}-{}_{:05d}.jpg``
template), the registry, batching (padding, ``valid``, dtype), the prefetch
thread (order, re-raise, close) and host batches to a CPU device.

All comparisons are exact: the two packages run the same numpy/PIL
arithmetic on the same inputs."""

import random
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import rubiksnet_torch.data as port
import rubiksnet_tpu.data as ref
from rubiksnet_torch.data import transforms as port_tf
from rubiksnet_tpu.data import transforms as ref_tf

torch.set_num_threads(1)

FRAME_COUNTS = [1, 3, 4, 7, 8, 9, 16, 20, 40, 64, 66, 130]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- samplers

SAMPLERS = {
    "train": lambda m, n, seed, even: m.sample_train_indices(
        n, 8, even, 1, rng=np.random.RandomState(seed)),
    "train_len2": lambda m, n, seed, even: m.sample_train_indices(
        n, 4, even, 2, rng=np.random.RandomState(seed)),
    "dense": lambda m, n, seed, even: m.sample_dense_indices(
        n, 8, even, rng=np.random.RandomState(seed)),
    "all": lambda m, n, seed, even: m.sample_all_indices(
        n, 8, rng=np.random.RandomState(seed)),
    "val": lambda m, n, seed, even: m.sample_val_indices(n, 8, even),
    "val_len2": lambda m, n, seed, even: m.sample_val_indices(n, 4, even, 2),
    "test": lambda m, n, seed, even: m.sample_test_indices(
        n, 8, only_even=even),
    "test_twice": lambda m, n, seed, even: m.sample_test_indices(
        n, 8, twice_sample=True, only_even=even),
    "test_dense": lambda m, n, seed, even: m.sample_test_indices(
        n, 8, dense_sample=True, only_even=even),
    "test_all": lambda m, n, seed, even: m.sample_test_indices(
        n, 8, all_sample=True, only_even=even),
}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("mode", sorted(SAMPLERS))
def test_samplers_match_jax(mode, seed):
    """The same 1-based frame indices as the JAX samplers for every frame
    count, both even-index settings and the seed."""
    for n in FRAME_COUNTS:
        for even in (True, False):
            if mode == "test_dense" and n < 2:
                continue
            if mode in ("train", "train_len2", "dense") and even and n < 2:
                continue  # an even-index video of one frame has none
            _same(SAMPLERS[mode](port, n, seed, even),
                  SAMPLERS[mode](ref, n, seed, even))


# -------------------------------------------------------------- transforms

def _frames(n, w=96, h=72, channels=3, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        arr = rng.randint(0, 255, (h, w, channels), dtype=np.uint8)
        out.append(Image.fromarray(arr.squeeze() if channels == 1 else arr))
    return out


def _clip(n=4, w=96, h=72):
    return np.random.RandomState(3).randint(0, 255, (n, h, w, 3)).astype(
        np.uint8)


# name -> (build(module), input maker); every transform of the surface
TRANSFORMS = {
    "Compose": (lambda m: m.Compose([m.GroupScale(40), m.GroupCenterCrop(32),
                                     m.Stack(), m.ToClipArray()]),
                lambda: _frames(4)),
    "GroupCenterCrop": (lambda m: m.GroupCenterCrop(41), lambda: _frames(3)),
    "GroupFullResSample": (lambda m: m.GroupFullResSample(48, 64),
                           lambda: _frames(4)),
    "GroupFullResSample_noflip": (
        lambda m: m.GroupFullResSample(48, None, flip=False),
        lambda: _frames(4)),
    "GroupMultiScaleCrop": (lambda m: m.GroupMultiScaleCrop(48),
                            lambda: _frames(3)),
    "GroupMultiScaleCrop_free": (
        lambda m: m.GroupMultiScaleCrop(48, [1, 0.8], max_distort=0,
                                        fix_crop=False),
        lambda: _frames(3)),
    "GroupNormalize": (lambda m: m.GroupNormalize((0.4, 0.5, 0.6),
                                                  (0.2, 0.25, 0.3)),
                       lambda: _clip().astype(np.float32) / 255.0),
    "GroupOverSample": (lambda m: m.GroupOverSample(40, 56),
                        lambda: _frames(2)),
    "GroupRandomCrop": (lambda m: m.GroupRandomCrop((40, 56)),
                        lambda: _frames(3)),
    "GroupRandomHorizontalFlip": (lambda m: m.GroupRandomHorizontalFlip(),
                                  lambda: _frames(3)),
    "GroupRandomHorizontalFlip_flow": (
        lambda m: m.GroupRandomHorizontalFlip(is_flow=True),
        lambda: _frames(4, channels=1)),
    "GroupRandomSizedCrop": (lambda m: m.GroupRandomSizedCrop(32),
                             lambda: _frames(3)),
    "GroupRandomSizedCrop_fallback": (lambda m: m.GroupRandomSizedCrop(32),
                                      lambda: _frames(2, w=4, h=300)),
    "GroupScale": (lambda m: m.GroupScale(50), lambda: _frames(3)),
    "GroupScale_tall": (lambda m: m.GroupScale(50),
                        lambda: _frames(2, w=60, h=90)),
    "IdentityTransform": (lambda m: m.IdentityTransform(), _clip),
    "Stack": (lambda m: m.Stack(), lambda: _frames(3)),
    "Stack_roll": (lambda m: m.Stack(roll=True), lambda: _frames(3)),
    "ToClipArray": (lambda m: m.ToClipArray(), _clip),
    "ToClipArray_nodiv": (lambda m: m.ToClipArray(div=False), _clip),
}


def _as_array(out):
    if isinstance(out, list):  # GroupScale keeps PIL frames
        return np.stack([np.asarray(im) for im in out])
    return np.asarray(out)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name, seed):
    """Each transform gives the JAX transform's array under the same
    ``random.seed``, three draws in a row."""
    build, make = TRANSFORMS[name]
    ours, theirs = build(port), build(ref)
    random.seed(seed)
    got = [_as_array(ours(make())) for _ in range(3)]
    random.seed(seed)
    want = [_as_array(theirs(make())) for _ in range(3)]
    for g, w in zip(got, want):
        _same(g, w)


def test_transform_surface_is_the_jax_one():
    assert sorted(port_tf.__all__) == sorted(ref_tf.__all__)
    assert len(port_tf.__all__) == 13
    for name in port_tf.__all__:
        assert getattr(port, name) is getattr(port_tf, name)


@pytest.mark.parametrize("fn,args", [
    ("fix_crop_anchors", (96, 72, 48, 40, True)),
    ("fix_crop_anchors", (96, 72, 48, 40, False)),
    ("horizontal_3crop_offsets", (340, 256, 224, 224)),
])
def test_crop_tables_match_jax(fn, args):
    assert getattr(port_tf, fn)(*args) == getattr(ref_tf, fn)(*args)


# ----------------------------------------------------------------- dataset

def _write_videos(root, counts, tmpl="img_{:05d}.jpg", size=(40, 30),
                  missing=()):
    rows = []
    for v, n in enumerate(counts):
        d = root / f"vid{v}"
        d.mkdir(parents=True)
        for f in range(1, n + 1):
            if (v, f) in missing:
                continue
            Image.fromarray(
                np.full((size[1], size[0], 3), (v * 37 + f * 5) % 255,
                        np.uint8)).save(d / tmpl.format(f))
        rows.append(f"vid{v} {n} {v % 3}")
    return rows


@pytest.fixture(scope="module")
def video_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("rgb")
    rows = _write_videos(root, [12, 2, 30, 7], missing={(2, 9)})
    lst = root / "list.txt"
    lst.write_text("\n".join(rows + ["short_line 3", "", "vid0 12 1"])
                   + "\n")
    return root, lst


@pytest.mark.parametrize("test_mode,remove_missing,halve", [
    (False, False, False), (True, False, False), (True, True, False),
    (False, False, True)])
def test_parse_list_file_matches_jax(video_root, test_mode, remove_missing,
                                     halve):
    _, lst = video_root
    got = port.parse_list_file(str(lst), test_mode, remove_missing, halve)
    want = ref.parse_list_file(str(lst), test_mode, remove_missing, halve)
    assert [(r.path, r.num_frames, r.label) for r in got] == [
        (r.path, r.num_frames, r.label) for r in want]


DATASET_MODES = {
    "train": dict(random_shift=True),
    "val": dict(random_shift=False),
    "train_dense": dict(dense_sample=True),
    "train_all": dict(all_sample=True),
    "test": dict(test_mode=True, remove_missing=True),
    "test_twice": dict(test_mode=True, twice_sample=True),
    "test_new_length": dict(test_mode=True, new_length=2),
}


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("mode", sorted(DATASET_MODES))
def test_dataset_matches_jax(video_root, mode, seed):
    """Indices, frames (missing frames retried as frame 2) and labels of
    every item equal the JAX dataset's, through a crop-and-stack
    transform."""
    root, lst = video_root
    kw = dict(num_segments=4, image_tmpl="img_{:05d}.jpg",
              only_even_indices=False, seed=seed, **DATASET_MODES[mode])

    def build(m):
        t = m.Compose([m.GroupScale(24), m.GroupCenterCrop(24), m.Stack()])
        return m.RubiksDataset(str(root), str(lst), transform=t, **kw)

    ours, theirs = build(port), build(ref)
    assert len(ours) == len(theirs)
    for (clip_a, lab_a), (clip_b, lab_b) in zip(ours, theirs):
        assert lab_a == lab_b
        _same(clip_a, clip_b)


def test_missing_frame_retries_frame_two(tmp_path):
    """A frame that cannot be read is replaced by frame 2 of the video, as
    the reference's loader retries."""
    _write_videos(tmp_path, [8], missing={(0, 5)})
    (tmp_path / "l.txt").write_text("vid0 8 2\n")
    ds = port.RubiksDataset(str(tmp_path), str(tmp_path / "l.txt"), 8,
                            test_mode=True, all_sample=True,
                            only_even_indices=False)
    frames, label = ds[0]
    assert label == 2 and len(frames) == 8
    np.testing.assert_array_equal(np.asarray(frames[4]),
                                  np.asarray(frames[1]))


def test_ssv2_template_halves_and_names_frames(tmp_path):
    """``{:06d}-{}_{:05d}.jpg``: frame counts halved, files named
    ``000012/000012-x_00003.jpg``, as the JAX dataset (and the reference)
    read them."""
    tmpl = "{:06d}-{}_{:05d}.jpg"
    d = tmp_path / "000012"
    d.mkdir()
    for f in range(1, 21):
        Image.fromarray(np.full((8, 8, 3), f * 10, np.uint8)).save(
            d / tmpl.format(12, "x", f))
    (tmp_path / "l.txt").write_text("12 40 1\n")
    kw = dict(num_segments=4, image_tmpl=tmpl, test_mode=True,
              only_even_indices=False)
    ours = port.RubiksDataset(str(tmp_path), str(tmp_path / "l.txt"), **kw)
    theirs = ref.RubiksDataset(str(tmp_path), str(tmp_path / "l.txt"), **kw)
    assert ours.video_list[0].num_frames == 20
    rec = ours.video_list[0]
    assert ours._frame_path(rec, 3) == str(d / "000012-x_00003.jpg")
    assert ours._frame_path(rec, 3) == theirs._frame_path(
        theirs.video_list[0], 3)
    for a, b in zip(ours[0][0], theirs[0][0]):
        _same(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["something", "somethingv2", "somethingv1",
                                  "ucf101", "hmdb", "kinetics"])
def test_return_dataset_matches_jax(tmp_path, name):
    for v in ("somethingv1", "somethingv2"):
        (tmp_path / v / "label").mkdir(parents=True)
        (tmp_path / v / "label" / "category.txt").write_text(
            "\n".join(f"c{i}" for i in range(7 if v == "somethingv1" else 9))
            + "\n")
    assert port.return_dataset(name, str(tmp_path)) == ref.return_dataset(
        name, str(tmp_path))


def test_return_dataset_raises_on_unknown_name():
    with pytest.raises(ValueError, match="Unknown dataset"):
        port.return_dataset("somethingv3", "/")


# ---------------------------------------------------------------- batching

class _Clips:
    def __init__(self, n, dtype, views=2, frames=3):
        rng = np.random.RandomState(1)
        self.items = [((rng.rand(views * frames, 5, 6, 3) * 255).astype(dtype),
                       i % 4) for i in range(n)]

    def __iter__(self):
        return iter(self.items)


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.float64, np.float32])
@pytest.mark.parametrize("n", [4, 5, 1])
def test_batch_iterator_matches_jax(n, dtype, drop):
    """Fixed shapes, the short last batch zero-padded with ``valid``
    marking its real entries, uint8 kept and other dtypes as float32."""
    got = list(port.batch_iterator(_Clips(n, dtype), 2, 2, 3, drop))
    want = list(ref.batch_iterator(_Clips(n, dtype), 2, 2, 3, drop))
    assert len(got) == len(want) == (n // 2 if drop else -(-n // 2))
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            _same(x, y)
        assert a[0].shape == (2, 2, 3, 5, 6, 3)
        assert a[0].dtype == (np.uint8 if dtype == np.uint8 else np.float32)
    if n % 2 and not drop:
        np.testing.assert_array_equal(got[-1][2], [1.0, 0.0])
        assert not got[-1][0][1].any()


def test_batch_iterator_refuses_wrong_view_count():
    with pytest.raises(AssertionError):
        list(port.batch_iterator(_Clips(2, np.uint8, views=3), 2, 2, 3))


# ---------------------------------------------------------------- prefetch

def test_prefetch_yields_everything_in_order():
    assert list(port.prefetch(range(50), depth=3)) == list(range(50))
    assert list(port.PrefetchIterator(iter([]), depth=1)) == []


def test_prefetch_reraises_the_producers_error():
    def gen():
        yield 1
        yield 2
        raise KeyError("bad frame")

    it = port.prefetch(gen(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="bad frame"):
        next(it)


def test_prefetch_close_stops_the_thread():
    """close() ends the producer (blocked on a full queue) and a consumer
    that calls next() afterwards returns instead of waiting forever."""
    it = port.PrefetchIterator(iter(range(1000)), depth=2)
    time.sleep(0.2)  # let the producer fill the queue and block
    it.close()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()
    done = threading.Event()

    def drain():
        for _ in it:
            pass
        done.set()

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    t.join(timeout=5)
    assert done.is_set()


# ----------------------------------------------------- batches to a device

def test_device_batches_on_the_cpu_are_copies():
    video = np.arange(2 * 1 * 2 * 3 * 3 * 3, dtype=np.uint8).reshape(
        2, 1, 2, 3, 3, 3)
    labels = np.array([3, 1], np.int32)
    valid = np.array([1.0, 0.0], np.float32)
    (batch,) = list(port.device_batches([(video, labels, valid)], "cpu"))
    assert batch.ready is None and batch.valid is valid
    v, lab = batch.take()
    assert v.device.type == "cpu" and v.dtype == torch.uint8
    np.testing.assert_array_equal(v.numpy(), video)
    np.testing.assert_array_equal(lab.numpy(), labels)
    video[:] = 0  # the batch owns its memory
    assert v.sum() > 0
