"""The port's evaluator (``python -m rubiksnet_torch.scripts.test_models``)
against the JAX evaluator pipeline on synthetic frame folders.

The JAX side is what scripts/test_models.py drives: ``rubiksnet_tpu.data``
(dataset, Group* transforms or the native loader, ``batch_iterator``) and
a jitted ``make_eval_step``, with the JAX script's accounting (its
``AverageMeter``, ``per_class_accuracy``). The port's side is its own
``test_models.evaluate`` on the CPU, from the same weights
(``state_dict_from_jax`` -> ``.pth.tar`` -> ``load_pretrained``). Both
protocols, both loaders, ``--prefetch`` 0 and 2, the fused executor and
the module path. Geometry is cut to T = 4, crop 64, scale 72 (every path
is size-parametric; 224/256 are the transforms' own tests), and the
protocol test also runs at crop 56: there the third entry meets 7x7, which
the fused entry kernel K3, as its JAX counterpart, declines, so the
executor runs that block on the module path.

Tolerance: logits float32 within 1e-4 (the JAX script normalizes the PIL
path on the host, the port on the device; the executor sums in another
order); top-1, top-5 and per-class accuracy equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rubiksnet_torch.models import (
    FusedExecutor,
    create_rubiksnet,
    save_pretrained,
    state_dict_from_jax,
)
from rubiksnet_torch.scripts import eval_throughput, test_installation
from rubiksnet_torch.scripts import test_models
from rubiksnet_torch.train import make_eval_step
from rubiksnet_torch.utils import metrics as port_metrics
from rubiksnet_torch.utils.profiling import ThroughputMeter, Timer, trace
from rubiksnet_tpu.models import create_rubiksnet as jax_create

torch.set_num_threads(1)

T, CROP, SCALE, NUM_CLASSES, BATCH = 4, 64, 72, 5, 2
TMPL = "{:05d}.jpg"
TOL = 1e-4
VIDEOS = 5  # the last batch of 2 is padded


@pytest.fixture(scope="module")
def frame_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(0)
    lines = []
    for vi in range(VIDEOS):
        d = root / f"vid{vi}"
        d.mkdir()
        n_frames = 12 + 2 * vi
        for f in range(1, n_frames + 1):
            base = rng.randint(0, 200, (68, 96, 3)).astype(np.uint8)
            Image.fromarray(base).save(str(d / TMPL.format(f)), quality=95)
        lines.append(f"vid{vi} {n_frames} {vi % NUM_CLASSES}")
    (root / "val.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A JAX tiny model with non-trivial BN, and the port's checkpoint of
    the same weights."""
    bundle = jax_create("tiny", num_classes=NUM_CLASSES, num_frames=T,
                        input_size=32, shift_max_shift=1,
                        rng=jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)

    def randomized(path, leaf):
        name = getattr(path[-1], "key", "")
        lo, hi = {"scale": (0.5, 1.5), "mean": (-0.2, 0.2),
                  "var": (0.5, 2.0)}.get(name, (None, None))
        if name == "bias" and "new_fc" not in str(path):
            lo, hi = -0.3, 0.3
        if lo is None:
            return leaf
        return jnp.asarray(rng.uniform(lo, hi, leaf.shape).astype(np.float32))

    bundle.variables = jax.tree_util.tree_map_with_path(
        randomized, dict(bundle.variables))
    model = create_rubiksnet("tiny", NUM_CLASSES, T, max_shift=1,
                             device="cpu")
    model.load_state_dict(state_dict_from_jax(
        bundle.variables["params"], bundle.variables["batch_stats"]))
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pth.tar"
    save_pretrained(model, path)
    return bundle, str(path)


_JAX_RESULTS = {}


def jax_evaluator(bundle, root, two_clips, loader, crop=CROP):
    """The JAX evaluator's pipeline and accounting (scripts/test_models.py:
    transforms, dataset, native loader with uint8 normalized in the step,
    batch_iterator, jitted make_eval_step, AverageMeter, per-class)."""
    key = (str(root), two_clips, loader, crop)
    if key in _JAX_RESULTS:
        return _JAX_RESULTS[key]
    from rubiksnet_tpu.data import (
        Compose, GroupCenterCrop, GroupFullResSample, GroupNormalize,
        GroupScale, NativeEvalDataset, RubiksDataset, Stack, ToClipArray,
        batch_iterator,
    )
    from rubiksnet_tpu.models import INPUT_MEAN, INPUT_STD
    from rubiksnet_tpu.train.steps import make_eval_step as jax_eval_step
    from rubiksnet_tpu.utils import AverageMeter, per_class_accuracy

    if two_clips:
        cropping = Compose([GroupFullResSample(crop, SCALE, flip=False)])
    else:
        cropping = Compose([GroupScale(SCALE), GroupCenterCrop(crop)])
    views = 6 if two_clips else 1
    native = loader == "native"
    transform = Compose([cropping, Stack(roll=False), ToClipArray(div=True),
                         GroupNormalize(INPUT_MEAN, INPUT_STD)])
    ds = RubiksDataset(str(root), str(root / "val.txt"), num_segments=T,
                       new_length=1, image_tmpl=TMPL, test_mode=True,
                       remove_missing=True,
                       transform=None if native else transform,
                       dense_sample=False, twice_sample=two_clips)
    if native:
        ds = NativeEvalDataset(ds, SCALE, crop, INPUT_MEAN, INPUT_STD,
                               two_clips=two_clips, out_dtype="uint8")
    step = jax.jit(jax_eval_step(
        bundle.model, num_crops=views,
        normalize=(INPUT_MEAN, INPUT_STD) if native else None))
    top1, top5 = AverageMeter(), AverageMeter()
    logits, labels = [], []
    for video, lab, valid in batch_iterator(ds, BATCH, views, T):
        if not native:
            video = video.astype(np.float32)
        out = step(dict(bundle.variables), video, lab)
        n = int(valid.sum())
        lg, lab = np.asarray(out["logits"])[:n], lab[:n]
        preds = lg.argmax(1)
        top1.update(100.0 * float(np.mean(preds == lab)), n)
        order5 = np.argsort(-lg, axis=1)[:, :5]
        top5.update(100.0 * float(np.mean((order5 == lab[:, None]).any(1))),
                    n)
        logits.append(lg)
        labels.append(lab)
    logits, labels = np.concatenate(logits), np.concatenate(labels)
    result = {"logits": logits, "labels": labels, "top1": top1.avg,
              "top5": top5.avg,
              "class_accuracy": per_class_accuracy(labels, logits.argmax(1),
                                                   NUM_CLASSES)}
    _JAX_RESULTS[key] = result
    return result


def port_args(ckpt, root, *extra):
    return test_models.build_parser().parse_args(
        ["-p", ckpt, "--val-list", str(root / "val.txt"), "--root-path",
         str(root), "--image-tmpl", TMPL, "--num-classes", str(NUM_CLASSES),
         "--frames", str(T), "--batch-size", str(BATCH), *extra])


class _Counting(FusedExecutor):
    built = 0

    def __init__(self, model):
        type(self).built += 1
        super().__init__(model)


@pytest.fixture
def counted_executors(monkeypatch):
    """Counts the evaluator's FusedExecutor constructions, and fails any
    per-batch restacking (fused_infer_apply)."""
    _Counting.built = 0
    monkeypatch.setattr(test_models, "FusedExecutor", _Counting)

    def restack(*a, **k):
        raise AssertionError("fused_infer_apply called by the evaluator")

    monkeypatch.setattr("rubiksnet_torch.train.steps.fused_infer_apply",
                        restack)
    return _Counting


def _agree(got, want):
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["logits"], want["logits"], atol=TOL,
                               rtol=0)
    assert got["top1"] == want["top1"] and got["top5"] == want["top5"]
    np.testing.assert_array_equal(got["class_accuracy"],
                                  want["class_accuracy"])


def _protocol_case(frame_root, weights, counted_executors, two_clips,
                   loader, prefetch, crop):
    """The evaluator at ``crop`` against the JAX pipeline; -> its result."""
    from rubiksnet_torch.data import native_loader

    if loader == "native" and not native_loader.toolchain_present():
        pytest.skip("g++ or libjpeg is missing")
    if loader == "native":
        from rubiksnet_tpu.data import native_loader as jax_loader

        if not jax_loader.available():
            pytest.skip("the JAX package's loader does not build here")
    bundle, ckpt = weights
    extra = ["--loader", loader, "--prefetch", str(prefetch), "--device",
             "cpu"] + (["--two-clips"] if two_clips else [])
    got = test_models.evaluate(port_args(ckpt, frame_root, *extra),
                               crop, SCALE, log=lambda *a: None)
    want = jax_evaluator(bundle, frame_root, two_clips, loader, crop)
    _agree(got, want)
    return got


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("loader", ["pil", "native"])
@pytest.mark.parametrize("two_clips", [False, True],
                         ids=["1clip", "2clip"])
def test_evaluator_matches_jax_pipeline(frame_root, weights,
                                        counted_executors, two_clips, loader,
                                        prefetch):
    """Logits within 1e-4 and the same top-1, top-5 and per-class accuracy
    as the JAX pipeline; one FusedExecutor for the whole run."""
    got = _protocol_case(frame_root, weights, counted_executors, two_clips,
                         loader, prefetch, CROP)
    assert got["logits"].shape == (VIDEOS, NUM_CLASSES)
    assert got["batches"] == 3
    assert counted_executors.built == 1
    st = got["stats"]
    assert st["videos"] == VIDEOS and st["loader"] == loader
    assert st["views_per_video"] == (6 if two_clips else 1)
    assert st["device"] == "cpu" and st["device_normalize"]


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("loader", ["pil", "native"])
@pytest.mark.parametrize("two_clips", [False, True],
                         ids=["1clip", "2clip"])
def test_evaluator_matches_jax_pipeline_at_crop_56(
        frame_root, weights, counted_executors, two_clips, loader, prefetch):
    """The same at crop 56, where the third entry block meets 7x7: the held
    executor runs it on the module path (the JAX executor's fallback), and
    the run agrees with the JAX pipeline as at crop 64."""
    got = _protocol_case(frame_root, weights, counted_executors, two_clips,
                         loader, prefetch, 56)
    assert got["logits"].shape == (VIDEOS, NUM_CLASSES)
    assert got["batches"] == 3 and counted_executors.built == 1


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("two_clips", [False, True],
                         ids=["1clip", "2clip"])
def test_evaluator_device_loader_matches_jax_pipeline(
        frame_root, weights, counted_executors, two_clips, prefetch):
    """``--loader device --device cpu``: the device loader's plain
    versions (Pillow's decode, the C++ loader's resize and crop step for
    step) through ``device_batches_from_files``, against the JAX pipeline
    on its native loader: logits within 1e-4, the same accuracies, one
    FusedExecutor."""
    from rubiksnet_torch.data import native_loader
    from rubiksnet_tpu.data import native_loader as jax_loader

    if not native_loader.toolchain_present() or not jax_loader.available():
        pytest.skip("the JAX package's native loader does not build here")
    bundle, ckpt = weights
    extra = ["--loader", "device", "--prefetch", str(prefetch), "--device",
             "cpu"] + (["--two-clips"] if two_clips else [])
    got = test_models.evaluate(port_args(ckpt, frame_root, *extra), CROP,
                               SCALE, log=lambda *a: None)
    _agree(got, jax_evaluator(bundle, frame_root, two_clips, "native"))
    assert got["batches"] == 3 and counted_executors.built == 1
    assert got["stats"]["loader"] == "device"
    assert got["stats"]["device_normalize"]


@pytest.mark.parametrize("backend,host_normalize", [
    ("model", False), ("fused", True)])
def test_module_path_and_host_normalize(frame_root, weights,
                                        counted_executors, backend,
                                        host_normalize):
    """``--backend model`` builds no executor; ``--host-normalize`` ships
    float32 normalized on the host (as the JAX PIL path does): both agree
    with the JAX pipeline."""
    bundle, ckpt = weights
    extra = ["--loader", "pil", "--backend", backend, "--device", "cpu",
             "--two-clips"] + (["--host-normalize"] if host_normalize else [])
    got = test_models.evaluate(port_args(ckpt, frame_root, *extra), CROP,
                               SCALE, log=lambda *a: None)
    _agree(got, jax_evaluator(bundle, frame_root, True, "pil"))
    assert counted_executors.built == (1 if backend == "fused" else 0)
    assert got["stats"]["device_normalize"] is not host_normalize


def test_main_prints_the_reference_log_and_stats(frame_root, weights,
                                                 tmp_path, capsys):
    """main(argv) at the protocols' own geometry (scale 256, crop 224): the
    reference's log lines, and the --stats-out record with the JAX script's
    keys (and no other)."""
    import json

    _, ckpt = weights
    stats_path = tmp_path / "stats.json"
    out = test_models.main(
        ["-p", ckpt, "--val-list", str(frame_root / "val.txt"),
         "--root-path", str(frame_root), "--num-classes", str(NUM_CLASSES),
         "--frames", str(T), "--batch-size", str(BATCH), "--device", "cpu",
         "--loader", "pil", "--limit", "3", "--stats-out", str(stats_path)])
    text = capsys.readouterr().out
    for line in ("=> dataset: folder list", "=> num_classes: 5",
                 "=> eval mode: 1-clip", "=> videos: 3", "=> tier: tiny",
                 "video 2 done, total 2/3", "Evaluation Complete",
                 "Class accuracy:", "Accuracy: top 1:"):
        assert line in text
    stats = json.loads(stats_path.read_text())
    assert set(stats) == {
        "videos", "videos_per_s", "sec_per_video", "steady_videos_per_s",
        "steady_sec_per_video", "first_batch_s", "device_normalize",
        "wall_s", "host_wait_s", "host_wait_frac", "device_step_fetch_s",
        "device_frac", "two_clips", "views_per_video", "batch_size",
        "prefetch", "loader", "backend", "dtype", "tier", "top1", "top5",
        "device"}
    assert stats["videos"] == 3 == len(out["labels"])
    assert 0.0 <= stats["host_wait_frac"] <= 1.0


def test_entry_points_default_to_the_card():
    """Without --device the evaluator and test_installation take the CUDA
    card and raise where there is none (as create_rubiksnet does)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_models.main(["-p", "missing.pth.tar", "--val-list", "x",
                          "--num-classes", "3"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_installation.main([])


def test_installation_runs_on_the_cpu_when_asked(monkeypatch, capsys):
    """One forward pass of Large at its full width; here with one block a
    stage and 32 px, so the CPU test stays small."""
    from rubiksnet_torch.models import rubiksnet

    monkeypatch.setitem(rubiksnet.TIERS, "large", (72, (1, 1, 1, 1), False))
    monkeypatch.setattr(test_installation, "IMAGE_SIZE", 32)
    out = test_installation.main(["--device", "cpu"])
    assert out.shape == (2, 42) and torch.isfinite(out).all()
    assert "Installation successful!" in capsys.readouterr().out


def test_generator_is_seeded_and_ssv2_like(tmp_path):
    a = eval_throughput.generate_frames(str(tmp_path / "a"), 3, 4, seed=1)
    b = eval_throughput.generate_frames(str(tmp_path / "b"), 3, 4, seed=1)
    rows = open(a).read().split()
    assert rows == open(b).read().split()
    for name, n, label in zip(rows[0::3], rows[1::3], rows[2::3]):
        assert 24 <= int(n) <= 48
        first = tmp_path / "a" / name / TMPL.format(1)
        with Image.open(first) as im:
            assert im.size == (340, 256)
        assert (tmp_path / "a" / name / TMPL.format(int(n))).exists()
        np.testing.assert_array_equal(
            np.asarray(Image.open(first)),
            np.asarray(Image.open(tmp_path / "b" / name / TMPL.format(1))))


# ------------------------------------------------------- the eval step API

def test_eval_step_with_a_held_executor():
    model = create_rubiksnet("tiny", 7, 4, max_shift=1, device="cpu")
    executor = FusedExecutor(model)
    rng = np.random.default_rng(3)
    raw = torch.from_numpy(rng.integers(0, 256, (2, 3, 4, 32, 32, 3),
                                        dtype=np.uint8))
    labels = torch.tensor([1, 6])
    norm = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    held = make_eval_step(model, executor=executor, normalize=norm)
    fresh = make_eval_step(model, fused=True, normalize=norm)
    a, b = held(raw, labels), fresh(raw, labels)
    for k in ("logits", "top1", "top5"):
        assert torch.equal(a[k], b[k])
    other = create_rubiksnet("tiny", 7, 4, max_shift=1, device="cpu")
    with pytest.raises(ValueError, match="another model"):
        make_eval_step(other, executor=executor)


# ------------------------------------------------------ metrics, profiling

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    from rubiksnet_tpu.utils import metrics as jax_metrics

    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((40, 9)).astype(np.float32)
    labels = rng.integers(0, 9, 40)
    preds = logits.argmax(1)
    assert port_metrics.topk_accuracy(logits, labels, (1, 3, 5)) == (
        jax_metrics.topk_accuracy(logits, labels, (1, 3, 5)))
    for nc in (None, 12):
        np.testing.assert_array_equal(
            port_metrics.confusion_matrix(labels, preds, nc),
            jax_metrics.confusion_matrix(labels, preds, nc))
        np.testing.assert_array_equal(
            port_metrics.per_class_accuracy(labels, preds, nc),
            jax_metrics.per_class_accuracy(labels, preds, nc))
    a, b = port_metrics.AverageMeter(), jax_metrics.AverageMeter()
    for v, n in zip(rng.random(7), rng.integers(1, 5, 7)):
        a.update(v, n)
        b.update(v, n)
    assert (a.val, a.avg, a.sum, a.count) == (b.val, b.avg, b.sum, b.count)


def test_timer_throughput_and_trace(tmp_path):
    t = Timer()
    with t:
        pass
    first = t.elapsed
    with t:
        pass
    assert t.elapsed >= first >= 0.0
    m = ThroughputMeter(warmup=2)
    m.update(5)
    assert m.items_per_sec == 0.0
    m.update(5)
    m.update(8)
    assert m.items_per_sec > 0.0
    with trace(None) as prof:
        assert prof is None
    with trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
