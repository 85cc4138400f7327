"""The device loader (``rubiksnet_torch.data.device_loader``,
``device_eval``) on the CPU, where its plain versions run: nvjpeg and the
``resize_crop_u8`` kernel exist only on the card (``chip_smoke.py`` phase 7
holds the kernel to ``plain_resize_crop`` bit for bit there, and nvjpeg to
Pillow within ``DECODE_BOUND``).

Here: ``plain_resize_crop`` equals the port's native (C++/libjpeg) loader
bit for bit on the native loader's own scale-0 decode (non-square frames
in both orientations, downscales of every ``ksize`` and upscales, 1 and 3
crops, centre and full-resolution origins); the coefficient table equals a
transcription of ``triangle_coeffs``; the kernel's decomposition (its
tables and its index walk, emulated in float64 numpy) equals the plain
version; ``device_batches_from_files`` gives the rows, labels, ``valid``
and padding of ``device_batches(batch_iterator(NativeEvalDataset))`` at
world 1 and 2, clips within 1 level (Pillow's decode against libjpeg's) and
bit-identical on the native decode; the evaluator's ``--loader`` rules;
and no fallback where the library cannot be built. Sizes: crop 64 at scale
72 (as tests/test_torch_eval_protocol.py), 4 frames, a few videos. The
tests that compare with the native loader skip where it does not build."""

import ctypes
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

import rubiksnet_torch.data as port
from rubiksnet_torch.data import device_loader as dl
from rubiksnet_torch.data import native_loader
from rubiksnet_torch.data.native_eval import center_offset, full_res_offsets
from rubiksnet_torch.ops import _build
from rubiksnet_torch.scripts import test_models

torch.set_num_threads(1)

SCALE, CROP, T = 72, 64, 4
# (width, height): landscape and portrait, up to 72 (ksize 3), the scale
# itself (no resize), and down by a factor in (1, 2] (ksize 5) and (2, 3]
# (ksize 7).
SIZES = [(96, 68), (68, 96), (60, 40), (100, 72), (150, 110), (200, 90),
         (90, 170)]


@pytest.fixture(scope="module")
def native():
    if not native_loader.toolchain_present():
        pytest.skip("g++ or libjpeg (header or library) is missing")
    return native_loader.load_library()


def smooth(rng, w, h):
    base = rng.randint(0, 255, (h // 8 + 1, w // 8 + 1, 3)).astype(np.uint8)
    return np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR))


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(3)
    paths = []
    for i, (w, h) in enumerate(SIZES):
        paths.append(str(d / f"f{i}.jpg"))
        Image.fromarray(smooth(rng, w, h)).save(paths[-1], quality=90)
    return paths


def native_decode(lib, path):
    """The native loader's own decode at scale 0: the whole frame as one
    crop of its size (``rl_load_frames_u8``)."""
    with Image.open(path) as im:
        w, h = im.size
    out = np.empty((h, w, 3), np.uint8)
    xs, ys = np.zeros(1, np.int32), np.zeros(1, np.int32)
    rc = lib.rl_load_frames_u8(
        (ctypes.c_char_p * 1)(os.fsencode(path)), 1, 0,
        native_loader._ptr(xs, ctypes.c_int),
        native_loader._ptr(ys, ctypes.c_int), w, h,
        native_loader._ptr(out, ctypes.c_uint8), w * h * 3, 1)
    assert rc == 0
    return out


def origins_of(w, h, crops, where):
    """A protocol's crop origins in the resized frame, or its corners."""
    rw, rh = dl.resized_size(w, h, SCALE)
    if where == "corners":
        return [(0, 0), (rw - CROP, rh - CROP), (-1, -1)][:crops]
    if crops == 3:
        return full_res_offsets(rw, rh, CROP)
    return [center_offset(rw, rh, CROP)]


@pytest.mark.parametrize("where", ["protocol", "corners"])
@pytest.mark.parametrize("crops", [1, 3])
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_plain_resize_crop_equals_the_native_loader(native, jpegs, size,
                                                    crops, where):
    path = jpegs[SIZES.index(size)]
    rgb, sizes = dl.pack_frames([native_decode(native, path)])
    origins = origins_of(*size, crops, where)
    got = dl.plain_resize_crop(rgb, sizes, SCALE, CROP, [origins]).numpy()
    if crops == 1:
        want = native_loader.load_frames_u8([path], SCALE, CROP,
                                            crop_offsets=origins,
                                            num_threads=1)
    else:
        want = native_loader.load_frames_multicrop_u8(
            [path], SCALE, CROP, crop_offsets=origins, num_threads=1)
    assert got.shape == want.shape == (crops, CROP, CROP, 3)
    np.testing.assert_array_equal(got, want)


def test_a_batch_of_mixed_sizes_is_crop_major_per_group(native, jpegs):
    """Several frames of several sizes in one call, grouped as videos:
    each group's crops are ``rl_load_frames_mc_u8``'s order of its frames,
    and the plain version at scale 0 is the decode's crop."""
    paths = jpegs[:6]
    rgb, sizes = dl.pack_frames([native_decode(native, p) for p in paths])
    origins = [origins_of(*SIZES[i], 3, "protocol") for i in range(6)]
    got = dl.plain_resize_crop(rgb, sizes, SCALE, CROP, origins,
                               group=1).numpy()
    for i, p in enumerate(paths):
        want = native_loader.load_frames_multicrop_u8(
            [p], SCALE, CROP, crop_offsets=origins[i])
        np.testing.assert_array_equal(got[3 * i:3 * i + 3], want)
    flat = dl.plain_resize_crop(rgb, sizes[:2], 0, 40, [[(1, 2)]] * 2)
    for i in range(2):
        np.testing.assert_array_equal(
            flat[i].numpy(), native_decode(native, paths[i])[2:42, 1:41])


def transcribed_coeffs(in_size, out_size):
    """rubiks_loader.cpp:87-119, line by line."""
    scale = float(in_size) / out_size
    filterscale = scale if scale > 1.0 else 1.0
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    rows = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ww = 0.0
        ss = 1.0 / filterscale
        xmin = int(max(center - support + 0.5, 0.0))
        xmax = int(min(center + support + 0.5, float(in_size))) - xmin
        k = [0.0] * ksize
        for x in range(xmax):
            arg = (x + xmin - center + 0.5) * ss
            weight = abs(arg)
            weight = 1.0 - weight if weight < 1.0 else 0.0
            k[x] = weight
            ww += weight
        if ww != 0.0:
            for x in range(xmax):
                k[x] /= ww
        rows.append((xmin, xmax, k))
    return ksize, rows


SWEEP = [(n, m) for n in (17, 40, 68, 72, 240, 256, 340, 427, 720)
         for m in (9, 64, 72, 256, 455)]


@pytest.mark.parametrize("in_size,out_size", SWEEP)
def test_coefficients_equal_triangle_coeffs(in_size, out_size):
    co = dl.triangle_coeffs(in_size, out_size)
    ksize, rows = transcribed_coeffs(in_size, out_size)
    assert co.ksize == ksize and co.weights.shape == (out_size, ksize)
    assert co.lo.tolist() == [r[0] for r in rows]
    assert co.counts.tolist() == [r[1] for r in rows]
    assert co.weights.tolist() == [r[2] for r in rows]  # exact doubles


def test_decode_batch_on_the_cpu_is_pillow(jpegs):
    blobs = [open(p, "rb").read() for p in jpegs[:3]]
    dl.reset_counts()
    rgb, sizes = dl.decode_batch(blobs, "cpu")
    assert dl.BACKEND_FRAMES == {"pillow": 3}
    assert sizes[:, :2].tolist() == [list(s) for s in SIZES[:3]]
    assert (sizes[:, 2] % dl.ALIGN == 0).all()
    for i, b in enumerate(blobs):
        w, h, start = sizes[i].tolist()
        np.testing.assert_array_equal(
            rgb[start:start + w * h * 3].view(h, w, 3).numpy(),
            dl.plain_decode(b))


def test_resize_crop_refusals(jpegs):
    rgb, sizes = dl.pack_frames([dl.plain_decode(open(jpegs[0], "rb")
                                                 .read())])
    with pytest.raises(ValueError, match="outside"):
        dl.resize_crop(rgb, sizes, SCALE, CROP, [[(60, 0)]])
    with pytest.raises(ValueError, match="groups"):
        dl.resize_crop(rgb, np.repeat(sizes, 2, 0), SCALE, CROP,
                       [[(0, 0)]] * 2, group=3)
    with pytest.raises(ValueError, match="out"):
        dl.resize_crop(rgb, sizes, SCALE, CROP, [[(0, 0)]],
                       out=torch.empty((1, CROP, CROP, 3)))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        dl.resize_crop(torch.empty(10, dtype=torch.uint8, device="meta"),
                       sizes, SCALE, CROP, [[(0, 0)]])


def test_decode_diff_and_its_bound():
    a = [np.full((4, 4, 3), 10, np.uint8)]
    b = [np.full((4, 4, 3), 10, np.uint8)]
    b[0][0, 0] = (19, 10, 12)
    d = dl.decode_diff(a, b)
    assert d["max_abs_diff"] == [9, 0, 2]
    assert d["mean_abs_diff"] == [9 / 16, 0.0, 2 / 16]
    assert d["within_bound"] is False  # 9 > DECODE_BOUND["max"]
    b[0][0, 0] = (18, 10, 12)
    assert dl.decode_diff(a, b)["within_bound"] is True
    b[0][:3] = 12  # mean 1.5 in every channel, max 2
    assert dl.decode_diff(a, b)["within_bound"] is False
    with pytest.raises(ValueError):
        dl.decode_diff(a, a + a)


# --------------------------------------------------------- the batches


@pytest.fixture(scope="module")
def frame_root(tmp_path_factory):
    """Five videos of frames of differing sizes and lengths."""
    root = tmp_path_factory.mktemp("videos")
    rng = np.random.RandomState(0)
    lines = []
    for vi, (w, h) in enumerate([(96, 68), (68, 96), (150, 110), (96, 68),
                                 (60, 40)]):
        (root / f"v{vi}").mkdir()
        n = 9 + 2 * vi
        for f in range(1, n + 1):
            Image.fromarray(smooth(rng, w, h)).save(
                root / f"v{vi}" / f"{f:05d}.jpg", quality=90)
        lines.append(f"v{vi} {n} {vi % 3}")
    (root / "val.txt").write_text("\n".join(lines) + "\n")
    return root


def _dataset(root, two_clips):
    return port.RubiksDataset(str(root), str(root / "val.txt"),
                              num_segments=T, image_tmpl="{:05d}.jpg",
                              test_mode=True, remove_missing=True,
                              twice_sample=two_clips)


@pytest.fixture
def native_decode_on_the_cpu(native, monkeypatch, tmp_path):
    """The device loader's CPU decode replaced by the native loader's."""
    def decode(blob):
        path = tmp_path / "frame.jpg"
        path.write_bytes(blob)
        return native_decode(native, str(path))

    monkeypatch.setattr(dl, "plain_decode", decode)


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 0), (2, 1)])
@pytest.mark.parametrize("two_clips", [False, True], ids=["1clip", "2clip"])
@pytest.mark.parametrize("decode", ["pillow", "native"])
def test_batches_equal_the_native_datasets(native, frame_root, two_clips,
                                           world, rank, decode, request):
    if decode == "native":
        request.getfixturevalue("native_decode_on_the_cpu")
    views = 6 if two_clips else 1
    batch = 4
    ref = list(port.device_batches(port.batch_iterator(
        port.NativeEvalDataset(_dataset(frame_root, two_clips), SCALE, CROP,
                               (0, 0, 0), (1, 1, 1), two_clips=two_clips,
                               out_dtype="uint8"),
        batch, views, T, rank=rank, world=world), "cpu"))
    got = list(port.device_batches_from_files(
        port.DeviceEvalDataset(_dataset(frame_root, two_clips), SCALE, CROP,
                               two_clips=two_clips),
        batch, views, T, rank=rank, world=world, device="cpu"))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.ready is None and g.video.dtype == torch.uint8
        assert g.video.shape == r.video.shape == (batch // world, views, T,
                                                  CROP, CROP, 3)
        assert torch.equal(g.labels, r.labels)
        assert g.labels.dtype == r.labels.dtype == torch.int32
        np.testing.assert_array_equal(g.valid, r.valid)
        n = int(r.valid.sum())
        assert not g.video[n:].any()  # zero padding
        diff = (g.video.int() - r.video.int()).abs().max()
        if decode == "native":
            assert int(diff) == 0
        else:
            assert int(diff) <= 1


def test_batches_refuse_a_batch_that_does_not_divide(frame_root):
    ds = port.DeviceEvalDataset(_dataset(frame_root, False), SCALE, CROP)
    with pytest.raises(ValueError, match="does not divide"):
        next(port.device_batches_from_files(ds, 3, 1, T, world=2,
                                            device="cpu"))
    with pytest.raises(ValueError, match="views"):
        next(port.device_batches_from_files(ds, 2, 6, T, device="cpu"))
    ds.ds.transform = port.Stack()
    with pytest.raises(ValueError, match="transform-less"):
        port.DeviceEvalDataset(ds.ds, SCALE, CROP)


# ------------------------------------------------ the evaluator's loaders


def _args(root, *extra):
    return test_models.build_parser().parse_args(
        ["-p", "unused.pth.tar", "--val-list", str(root / "val.txt"),
         "--root-path", str(root), "--num-classes", "3", "--frames",
         str(T), *extra])


def test_device_loader_refuses_host_normalize(frame_root):
    args = _args(frame_root, "--loader", "device", "--host-normalize",
                 "--device", "cpu")
    with pytest.raises(ValueError, match="host-normalize"):
        test_models.build_dataset(args, CROP, SCALE, log=lambda *a: None)


def test_device_loader_dataset_and_log(frame_root):
    lines = []
    ds, classes, views, loader, norm = test_models.build_dataset(
        _args(frame_root, "--loader", "device", "--two-clips", "--device",
              "cpu"), CROP, SCALE, log=lines.append)
    assert isinstance(ds, port.DeviceEvalDataset) and ds.two_clips
    assert (classes, views, loader, norm) == (3, 6, "device", True)
    assert any(ln.startswith("=> loader: device") for ln in lines)


@pytest.mark.parametrize("native_builds", [True, False])
def test_auto_keeps_its_loader_on_the_cpu(frame_root, monkeypatch,
                                          native_builds):
    """``auto``: native where it builds, else the device loader on a card,
    else PIL; on the CPU it never takes the device loader."""
    monkeypatch.setattr(native_loader, "available", lambda: native_builds)
    args = _args(frame_root, "--device", "cpu")
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert test_models.choose_loader(args, cpu) == (
        "native" if native_builds else "pil")
    assert test_models.choose_loader(args, card) == (
        "native" if native_builds else "device")
    for name in ("pil", "native", "device"):
        args = _args(frame_root, "--loader", name, "--device", "cpu")
        assert test_models.choose_loader(args, card) == name


def test_no_nvcc_here_and_no_fallback(monkeypatch, tmp_path):
    """This machine has no nvcc: the probe says so without building, and
    the library raises rather than falling back (and again on a second
    call: a failure is not cached as a library); a build with no nvjpeg
    header raises too."""
    assert dl.toolchain_present() is False
    dl.load_library.cache_clear()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    try:
        for _ in range(2):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                dl.load_library()
        monkeypatch.setattr(_build, "_find_nvcc", lambda: "/bin/true")
        monkeypatch.setattr(dl, "nvjpeg_files",
                            lambda: {"headers": [], "libraries": []})
        dl.load_library.cache_clear()
        with pytest.raises(RuntimeError, match="nvjpeg.h not found"):
            dl.load_library()
        assert not list(tmp_path.iterdir())
    finally:
        dl.load_library.cache_clear()


def test_probe_without_nvjpeg(monkeypatch):
    monkeypatch.setattr(dl, "nvjpeg_files",
                        lambda: {"headers": [], "libraries": []})
    monkeypatch.setattr(dl.ctypes.util, "find_library", lambda name: None)
    out = dl.probe()
    assert out["library"] is None and out["version"] is None
    assert out["create_hardware"] is None
