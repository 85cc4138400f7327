"""The port's native (C++/libjpeg) loader, ``rubiksnet_torch.data.
native_loader``, built from its own copy of the source into
``rubiksnet_torch/build/``: the checks of tests/test_native_loader.py
against the PIL path, each entry point equal bit for bit to the JAX
package's binding on the same files (one source, one set of flags), the
evaluator's native dataset against the JAX one, and the refusals.

Skips only where g++ or libjpeg is missing (``toolchain_present``)."""

import numpy as np
import pytest
import torch
from PIL import Image

from rubiksnet_torch.data import native_loader
from rubiksnet_torch.ops import _build

torch.set_num_threads(1)

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.fixture(scope="module")
def lib():
    if not native_loader.toolchain_present():
        pytest.skip("g++ or libjpeg (header or library) is missing")
    return native_loader.load_library()


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    paths = []
    for i, (h, w) in enumerate([(240, 320), (240, 320), (300, 260)]):
        arr = (np.random.RandomState(i).rand(h, w, 3) * 255).astype(np.uint8)
        paths.append(str(d / f"f{i}.jpg"))
        Image.fromarray(arr).save(paths[-1], quality=95)
    return paths


def _pil_reference(path, scale, crop):
    img = Image.open(path).convert("RGB")
    w, h = img.size
    if w < h:
        ow, oh = scale, int(scale * h / w)
    else:
        oh, ow = scale, int(scale * w / h)
    img = img.resize((ow, oh), Image.BILINEAR)
    x1 = int(round((ow - crop) / 2.0))
    y1 = int(round((oh - crop) / 2.0))
    return np.asarray(img.crop((x1, y1, x1 + crop, y1 + crop)))


def test_decode_matches_pil_within_rounding(lib, jpegs):
    got = native_loader.decode_frame_u8(jpegs[0], 256, 224)
    ref = _pil_reference(jpegs[0], 256, 224)
    assert got.shape == ref.shape == (224, 224, 3)
    diff = np.abs(got.astype(int) - ref.astype(int))
    # triangle-filter resize matches PIL bilinear to rounding error
    assert diff.max() <= 2 and diff.mean() < 0.5


def test_batch_load_normalized(lib, jpegs):
    out = native_loader.load_frames([jpegs[0]] * 6, 256, 224, MEAN, STD)
    assert out.shape == (6, 224, 224, 3) and out.dtype == np.float32
    ref = ((_pil_reference(jpegs[0], 256, 224) / 255.0 - np.asarray(MEAN))
           / np.asarray(STD))
    assert np.abs(out[0] - ref).max() < 0.02  # ±1 uint8 of rounding
    np.testing.assert_array_equal(out[0], out[5])


def test_explicit_crop_offsets(lib, jpegs):
    out = native_loader.load_frames(
        [jpegs[0]] * 3, 256, 224, (0, 0, 0), (1, 1, 1),
        crop_offsets=[(0, 0), (0, 0), (40, 8)])
    np.testing.assert_array_equal(out[0], out[1])
    assert np.abs(out[0] - out[2]).max() > 0


@pytest.mark.parametrize("u8", [False, True])
def test_multicrop_matches_per_crop_load(lib, jpegs, u8):
    """Decode-once multicrop == the per-(frame, crop) path, bit for bit."""
    paths = jpegs[:2]
    offsets = [(0, 8), (60, 8), (30, 8)]
    rep_paths = [p for _ in offsets for p in paths]
    rep_offsets = [o for o in offsets for _ in paths]
    if u8:
        got = native_loader.load_frames_multicrop_u8(
            paths, 256, 224, crop_offsets=offsets)
        ref = native_loader.load_frames_u8(rep_paths, 256, 224,
                                           crop_offsets=rep_offsets)
    else:
        got = native_loader.load_frames_multicrop(
            paths, 256, 224, MEAN, STD, crop_offsets=offsets)
        ref = native_loader.load_frames(rep_paths, 256, 224, MEAN, STD,
                                        crop_offsets=rep_offsets)
    assert got.shape == (6, 224, 224, 3)
    assert got.dtype == (np.uint8 if u8 else np.float32)
    np.testing.assert_array_equal(got, ref)


def test_u8_batch_matches_normalized_f32(lib, jpegs):
    """Raw uint8 + normalize == the fused C++ normalize (the contract of
    the device-normalize input path)."""
    f32 = native_loader.load_frames([jpegs[0]] * 3, 256, 224, MEAN, STD)
    u8 = native_loader.load_frames_u8([jpegs[0]] * 3, 256, 224)
    assert u8.shape == (3, 224, 224, 3) and u8.dtype == np.uint8
    renorm = (u8.astype(np.float32) * np.float32(1.0 / 255.0)
              - np.asarray(MEAN, np.float32)) / np.asarray(STD, np.float32)
    np.testing.assert_allclose(renorm, f32, atol=1e-5, rtol=0)


def test_u8_crop_matches_decode_frame_u8(lib, jpegs):
    got = native_loader.load_frames_u8([jpegs[0]], 256, 224,
                                       crop_offsets=[(12, 4)])
    ref = native_loader.decode_frame_u8(jpegs[0], 256, 224, 12, 4)
    np.testing.assert_array_equal(got[0], ref)


def test_multicrop_reports_oob_crop(lib, jpegs):
    with pytest.raises(IOError):
        native_loader.load_frames_multicrop(
            [jpegs[0]], 256, 224, (0, 0, 0), (1, 1, 1),
            crop_offsets=[(10_000, 0)])


def test_missing_file_reports_failure(lib):
    with pytest.raises(IOError):
        native_loader.load_frames(["/nonexistent/frame.jpg"], 256, 224,
                                  (0, 0, 0), (1, 1, 1))


def test_offset_count_must_match(lib, jpegs):
    """Validated before the pointers reach C: one offset per frame."""
    with pytest.raises(ValueError, match="crop offsets"):
        native_loader.load_frames_u8(jpegs, 256, 224, crop_offsets=[(0, 0)])


# ------------------------------------------------- against the JAX binding

def _jax_binding():
    from rubiksnet_tpu.data import native_loader as jax_loader

    if not jax_loader.available():
        pytest.skip("the JAX package's loader does not build here")
    return jax_loader


ENTRIES = {
    "load_frames": lambda m, p: m.load_frames(
        p, 256, 224, MEAN, STD, crop_offsets=[(3, 5)] * len(p),
        num_threads=2),
    "load_frames_center": lambda m, p: m.load_frames(p, 200, 160, MEAN, STD),
    "load_frames_multicrop": lambda m, p: m.load_frames_multicrop(
        p, 256, 224, MEAN, STD, crop_offsets=[(0, 8), (30, 8), (16, 8)]),
    "load_frames_u8": lambda m, p: m.load_frames_u8(
        p, 256, 224, crop_offsets=[(16, 0)] * len(p)),
    "load_frames_u8_noscale": lambda m, p: m.load_frames_u8(p, 0, 224),
    "load_frames_multicrop_u8": lambda m, p: m.load_frames_multicrop_u8(
        p, 256, 224, crop_offsets=[(0, 8), (30, 8), (16, 8)]),
    "decode_frame_u8": lambda m, p: np.stack(
        [m.decode_frame_u8(q, 256, 224, 7, 1) for q in p]),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_equals_jax_binding_bit_for_bit(lib, jpegs, entry):
    jax_loader = _jax_binding()
    got = ENTRIES[entry](native_loader, jpegs)
    want = ENTRIES[entry](jax_loader, jpegs)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def frame_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    rng = np.random.RandomState(0)
    lines = []
    for vi in range(3):
        (root / f"v{vi}").mkdir()
        n = 10 + 3 * vi
        for f in range(1, n + 1):
            Image.fromarray(rng.randint(0, 255, (72, 100, 3)).astype(
                np.uint8)).save(root / f"v{vi}" / f"{f:05d}.jpg", quality=90)
        lines.append(f"v{vi} {n} {vi}")
    (root / "val.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.mark.parametrize("out_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("two_clips", [False, True])
def test_native_eval_dataset_equals_jax(lib, frame_root, two_clips,
                                        out_dtype):
    """NativeEvalDataset: the same clips as the JAX one, crop-major view
    order, in either output dtype."""
    _jax_binding()
    import rubiksnet_torch.data as port
    import rubiksnet_tpu.data as ref

    def clips(m):
        ds = m.RubiksDataset(str(frame_root), str(frame_root / "val.txt"),
                             num_segments=4, image_tmpl="{:05d}.jpg",
                             test_mode=True, remove_missing=True,
                             twice_sample=two_clips)
        return list(m.NativeEvalDataset(ds, 64, 56, MEAN, STD,
                                        two_clips=two_clips,
                                        out_dtype=out_dtype))

    for (a, la), (b, lb) in zip(clips(port), clips(ref)):
        assert la == lb and a.shape == ((24 if two_clips else 4), 56, 56, 3)
        assert a.dtype == np.dtype(out_dtype)
        np.testing.assert_array_equal(a, b)


def test_native_eval_dataset_refusals(lib, frame_root):
    import rubiksnet_torch.data as port

    ds = port.RubiksDataset(str(frame_root), str(frame_root / "val.txt"),
                            num_segments=4, image_tmpl="{:05d}.jpg",
                            test_mode=True)
    with pytest.raises(ValueError, match="out_dtype"):
        port.NativeEvalDataset(ds, 64, 56, MEAN, STD, out_dtype="float16")
    ds.transform = port.Stack()
    with pytest.raises(ValueError, match="transform-less"):
        port.NativeEvalDataset(ds, 64, 56, MEAN, STD)


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """A machine without g++: an empty build directory and no compiler."""
    native_loader.load_library.cache_clear()
    native_loader.available.cache_clear()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_loader, "_find_cxx", lambda: None)
    yield
    native_loader.load_library.cache_clear()
    native_loader.available.cache_clear()


def test_explicit_request_that_cannot_build_raises(no_compiler, frame_root):
    """No fallback: the library, the native dataset and the evaluator's
    ``--loader native`` raise; ``available()`` (the ``auto`` choice) and
    the probe say no."""
    import rubiksnet_torch.data as port
    from rubiksnet_torch.scripts import test_models

    assert not native_loader.available()
    assert not native_loader.toolchain_present()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native_loader.load_library()
    ds = port.RubiksDataset(str(frame_root), str(frame_root / "val.txt"),
                            num_segments=4, image_tmpl="{:05d}.jpg",
                            test_mode=True)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        port.NativeEvalDataset(ds, 64, 56, MEAN, STD)
    args = test_models.build_parser().parse_args(
        ["-p", "unused.pth.tar", "--val-list", str(frame_root / "val.txt"),
         "--root-path", str(frame_root), "--num-classes", "3", "--frames",
         "4", "--loader", "native", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        test_models.build_dataset(args, 56, 64, log=lambda *a: None)


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path,
                                                      lib):
    """A source that does not compile raises with g++'s message (into a
    build directory of its own, so the real library is untouched)."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    native_loader.load_library.cache_clear()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    try:
        with pytest.raises(RuntimeError, match="building librubiks_loader_"
                                               "[0-9a-f]+.so failed") as err:
            native_loader.load_library()
        assert "bad.cpp" in str(err.value) and "error" in str(err.value)
        assert not list((tmp_path / "build").iterdir())
    finally:
        native_loader.load_library.cache_clear()
