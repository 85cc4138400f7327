"""The port's training entry points (``python -m
rubiksnet_torch.scripts.train`` and ``...example_finetune``) against the JAX
script (scripts/train.py) and against the port's own train loop, on the CPU.

What holds the port's script to the JAX one is a chain:

* script = port loop: the script's losses and final state equal, bit for
  bit, a plain loop over ``make_train_step`` with the same batches and
  schedule (here), and so does a resumed run (JAX's resume semantics: the
  global step and the schedule continue, the data starts again at the
  first batch of epoch 0);
* port step = JAX step: tests/test_torch_train_parity.py (float64, 1e-5);
* schedule = optax: ``lr_schedule`` equals the optax schedules that
  scripts/train.py:244-257 builds, at every step 0..20 within 1e-7;
* data = JAX data: ``synthetic_batches`` equals the JAX script's bit for
  bit, and the registry path's first batches (random segments,
  GroupMultiScaleCrop, flip, random crop; uint8 divided by 255 in float32
  on the device) equal what ``rubiksnet_tpu.data`` gives from the same
  ``random`` seed and dataset seed.

Sizes: the tiny tier, 2-4 frames, 16-32 px, batch 2-4."""

import importlib.util
import random
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

from rubiksnet_torch.models import create_rubiksnet, load_pretrained
from rubiksnet_torch.models import save_pretrained
from rubiksnet_torch.scripts import eval_throughput, example_finetune
from rubiksnet_torch.scripts import train as port_train
from rubiksnet_torch.train import (
    load_train_state,
    lr_schedule,
    make_train_step,
    resume_schedule,
    sgd_with_shift_mult,
)

from rubiksnet_torch.utils.profiling import step_stats

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
T, SIZE, BATCH, CLASSES = 2, 16, 4, 5


def jax_script():
    """scripts/train.py, loaded by path (it imports only numpy at module
    level)."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_script", REPO / "scripts" / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def base_argv(ckpt_dir=None, *extra):
    argv = ["--synthetic", "12", "--tier", "tiny", "--num-classes",
            str(CLASSES), "--frames", str(T), "--input-size", str(SIZE),
            "--batch-size", str(BATCH), "--lr", "0.05", "--lr-schedule",
            "cosine", "--warmup-steps", "1", "--total-steps", "5",
            "--log-every", "1", "--device", "cpu", "--seed", "3"]
    if ckpt_dir is not None:
        argv += ["--checkpoint-dir", str(ckpt_dir)]
    return argv + list(extra)


def run(argv, **kw):
    return port_train.train(port_train.build_parser().parse_args(argv),
                            log=lambda *a: None, **kw)


def reference_loop(seed=3, lr=0.05):
    """The port's train loop by hand: the model, optimizer and schedule the
    script builds, and ``make_train_step``."""
    model = create_rubiksnet("tiny", CLASSES, T, device="cpu",
                             generator=torch.Generator().manual_seed(seed))
    opt, sched = sgd_with_shift_mult(model, lr_schedule("cosine", lr, 1, 5),
                                     0.1, 0.9, 1e-4)
    return model, opt, sched, make_train_step(model, opt, sched)


def batches_of(epoch, seed=3):
    for video, labels in port_train.synthetic_batches(12, CLASSES, T, SIZE,
                                                      BATCH, seed + epoch):
        yield torch.from_numpy(video), torch.from_numpy(labels).long()


def assert_same_state(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def assert_same_optimizer(a: dict, b: dict):
    assert a["state"].keys() == b["state"].keys()
    for k in a["state"]:
        assert torch.equal(a["state"][k]["momentum_buffer"],
                           b["state"][k]["momentum_buffer"]), k
    assert [g["lr"] for g in a["param_groups"]] == [
        g["lr"] for g in b["param_groups"]]


# ------------------------------------------------------------- the data

@pytest.mark.parametrize("n,classes,frames,size,batch,seed", [
    (12, 5, 2, 16, 4, 0), (10, 174, 3, 8, 3, 7), (8, 2, 1, 5, 8, 10_000)])
def test_synthetic_batches_equal_the_jax_script(n, classes, frames, size,
                                                batch, seed):
    want = list(jax_script().synthetic_batches(n, classes, frames, size,
                                               batch, seed))
    got = list(port_train.synthetic_batches(n, classes, frames, size, batch,
                                            seed))
    assert len(got) == len(want) == n // batch
    for (gv, gl), (wv, wl) in zip(got, want):
        assert gv.dtype == wv.dtype == np.float32
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gl, wl)


def jax_registry_batches(root, epoch_batches, seed, val=False):
    """The JAX script's registry pipeline: RubiksDataset, its transforms,
    batch_iterator (scripts/train.py:182-230)."""
    from rubiksnet_tpu.data import (
        Compose, GroupCenterCrop, GroupMultiScaleCrop, GroupRandomCrop,
        GroupRandomHorizontalFlip, GroupScale, Stack, ToClipArray,
    )
    from rubiksnet_tpu.data.config import return_dataset
    from rubiksnet_tpu.data.dataset import RubiksDataset
    from rubiksnet_tpu.data.dataset import batch_iterator as jax_batches

    _, train_list, val_list, data_root, tmpl = return_dataset(
        "somethingv2", str(root))
    if val:
        tf = Compose([GroupScale(int(SIZE * 256 / 224)),
                      GroupCenterCrop(SIZE), Stack(), ToClipArray(div=True)])
        ds = RubiksDataset(data_root, val_list, num_segments=T,
                           image_tmpl=tmpl, transform=tf, random_shift=False)
    else:
        tf = Compose([GroupMultiScaleCrop(256, [1, 0.875, 0.75, 0.66]),
                      GroupRandomHorizontalFlip(), GroupRandomCrop(SIZE),
                      Stack(), ToClipArray(div=True)])
        ds = RubiksDataset(data_root, train_list, num_segments=T,
                           image_tmpl=tmpl, transform=tf, random_shift=True,
                           seed=seed)
    out = []
    for video, labels, valid in jax_batches(ds, 2, num_crops=1,
                                            num_frames=T,
                                            drop_remainder=not val):
        out.append((video[:, 0], labels, valid))
        if len(out) == epoch_batches:
            break
    return out


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    root = tmp_path_factory.mktemp("ssv2")
    return eval_throughput.generate_registry(str(root), 5, 3, 3, seed=1)


def test_registry_layout(registry):
    base = Path(registry) / "somethingv2"
    assert len((base / "label" / "category.txt").read_text().split("\n")) \
        == 4
    train = (base / "label" / "train_videofolder.txt").read_text().split()
    val = (base / "label" / "val_videofolder.txt").read_text().split()
    assert train[0::3] == ["1", "2", "3", "4", "5"]
    assert val[0::3] == ["6", "7", "8"] and val[2::3] == ["2", "0", "1"]
    for vid, n in zip(train[0::3] + val[0::3], train[1::3] + val[1::3]):
        assert 24 <= int(n) <= 48
        assert (base / "rgb" / vid / f"{int(n):06d}.jpg").exists()
    again = eval_throughput.generate_registry(
        str(Path(registry).parent / "again"), 5, 3, 3, seed=1)
    assert (Path(again) / "somethingv2/label/train_videofolder.txt"
            ).read_text().split() == train


def test_registry_batches_equal_jax(registry):
    """The script's first two train batches and first val batch, through
    its feed (uint8 to the device, divided there), equal the JAX pipeline's
    float32 batches bit for bit, from the same random.seed and dataset
    seed."""
    argv = ["somethingv2", "--root", registry, "--frames", str(T),
            "--input-size", str(SIZE), "--batch-size", "2", "--seed", "5",
            "--device", "cpu"]
    args = port_train.build_parser().parse_args(argv)
    num_classes, steps, train_iter, val_iter = port_train.build_data(args)
    assert (num_classes, steps) == (3, 2)
    random.seed(11)
    # The whole epoch (2 batches): the prefetch thread, which draws from
    # random, is done before the JAX side draws.
    got = list(port_train.DataFeed(train_iter(0), "cpu", 2))
    random.seed(11)
    want = jax_registry_batches(registry, 2, seed=5)
    assert len(got) == len(want) == 2
    for (gv, gl, gvalid), (wv, wl, wvalid) in zip(got, want):
        assert gv.dtype == torch.float32 and wv.dtype == np.float32
        np.testing.assert_array_equal(gv.numpy(), wv)
        np.testing.assert_array_equal(gl.numpy(), wl)
        np.testing.assert_array_equal(gvalid, wvalid)
    host = next(train_iter(0))[0]
    assert host.dtype == np.uint8  # the clips leave the host as uint8
    gv = next(iter(port_train.DataFeed(val_iter(), "cpu", 0)))[0]
    (wv, _, _), = jax_registry_batches(registry, 1, seed=5, val=True)
    np.testing.assert_array_equal(gv.numpy(), wv)


def test_device_division_equals_to_clip_array():
    """uint8 / 255 in float32 on the device equals the host's
    ToClipArray(div=True) for every byte value."""
    from rubiksnet_tpu.data import ToClipArray

    every = np.arange(256, dtype=np.uint8).reshape(1, 4, 8, 8)
    got = port_train.to_unit(torch.from_numpy(every)).numpy()
    want = ToClipArray(div=True)(every)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- the schedule

def optax_schedule(kind, lr, warmup, total):
    """scripts/train.py:244-257."""
    if kind == "cosine":
        return optax.warmup_cosine_decay_schedule(
            init_value=0.0 if warmup else lr, peak_value=lr,
            warmup_steps=warmup, decay_steps=max(total, warmup + 1))
    if warmup:
        return optax.linear_schedule(0.0, lr, warmup)
    return lambda step: lr


@pytest.mark.parametrize("kind,warmup,total", [
    ("constant", 0, 0), ("constant", 5, 12), ("cosine", 0, 12),
    ("cosine", 4, 12), ("cosine", 3, 0), ("cosine", 0, 0),
    ("cosine", 25, 10)])
def test_lr_schedule_equals_optax(kind, warmup, total):
    want = optax_schedule(kind, 0.1, warmup, total)
    got = lr_schedule(kind, 0.1, warmup, total)
    for step in range(21):
        assert abs(got(step) - float(want(step))) <= 1e-7, step
    with pytest.raises(ValueError, match="unknown lr schedule"):
        lr_schedule("step", 0.1)


def test_schedule_drives_every_group_and_resumes():
    """Through sgd_with_shift_mult's LambdaLR each group takes lr(step)
    times its multiplier at each step; resume_schedule continues at a
    restored step."""
    fn = lr_schedule("cosine", 0.1, 2, 8)
    model = create_rubiksnet("tiny", 3, 2, device="cpu")
    opt, sched = sgd_with_shift_mult(model, fn, 0.1)
    mults = {"weight": 1.0, "bias": 1.0, "shift": 0.1}
    for step in range(5):
        assert [g["lr"] for g in opt.param_groups] == [
            fn(step) * mults[g["name"]] for g in opt.param_groups]
        opt.step()
        sched.step()
    opt2, sched2 = sgd_with_shift_mult(model, fn, 0.1)
    resume_schedule(sched2, 5)
    assert [g["lr"] for g in opt2.param_groups] == [
        g["lr"] for g in opt.param_groups]
    opt.step()
    sched.step()
    opt2.step()
    sched2.step()
    assert sched2.last_epoch == sched.last_epoch == 6
    assert [g["lr"] for g in opt2.param_groups] == [
        g["lr"] for g in opt.param_groups]


# --------------------------------------------- the script and the loop

def test_script_equals_the_port_loop(tmp_path):
    """Three steps through the script (prefetch thread, feed, validation
    every 2 steps) give the losses and the state of the loop over
    make_train_step on the same batches, bit for bit."""
    got = run(base_argv(tmp_path, "--steps", "3", "--val-every", "2",
                        "--val-size", "4"))
    model, opt, _, step = reference_loop()
    want = [float(step(v, lab)["loss"]) for v, lab in batches_of(0)]
    assert got["losses"] == want and got["global_step"] == 3
    assert all(np.isfinite(got["losses"]))
    assert_same_state(got["model"].state_dict(), model.state_dict())
    saved = torch.load(got["checkpoint"], weights_only=True)
    assert saved["step"] == 3
    assert_same_optimizer(saved["optimizer"], opt.state_dict())
    assert [v[0] for v in got["val"]] == [2] and got["val_batches"] == 1
    assert len(got["step_s"]) == len(got["wait_s"]) == 3
    assert got["host_wait_frac"] == step_stats(
        got["step_s"], got["wait_s"], BATCH)["host_wait_frac"]
    assert 0.0 <= got["host_wait_frac"] <= 1.0
    assert got["peak_memory_bytes"] is None and got["device"] == "cpu"


def test_step_stats_read_the_steps_after_the_first():
    """The median, clips/s and host-wait share leave out the first step
    (the build and the filling of the prefetch queue); a run is steady
    from 3 steps after the first; one step is read as it is."""
    st = step_stats([0.6, 0.1, 0.3, 0.2], [0.4, 0.0, 0.1, 0.05], 8)
    assert st["steps"] == 3 and st["steady"]
    assert st["median_s"] == 0.2 and st["first_s"] == 0.6
    assert st["first_wait_s"] == 0.4
    assert st["clips_s"] == pytest.approx(24 / 0.6)
    assert st["host_wait_frac"] == pytest.approx(0.15 / 0.6)
    assert not step_stats([0.6, 0.1], [0.4, 0.0], 8)["steady"]
    one = step_stats([0.5], [0.1], 2)
    assert one["steps"] == 1 and one["host_wait_frac"] == pytest.approx(0.2)


def test_resume_continues_the_step_and_the_schedule(tmp_path):
    """Save at step 2, then --resume for one step: global step 3, and the
    state of the loop that restores the step-2 state and takes one step on
    epoch 0's first batch at lr(2), bit for bit (JAX's resume semantics)."""
    first = run(base_argv(tmp_path, "--steps", "2", "--save-every", "2"))
    ckpt = tmp_path / "train_state_00000002.pt"
    assert first["checkpoint"] == str(ckpt) and ckpt.exists()
    fn = lr_schedule("cosine", 0.05, 1, 5)
    seen = {}

    def after_resume(model, optimizer, scheduler, path):
        seen["path"] = path
        seen["lr"] = [g["lr"] for g in optimizer.param_groups]
        seen["last_epoch"] = scheduler.last_epoch

    resumed = run(base_argv(tmp_path, "--steps", "1", "--resume"),
                  after_resume=after_resume)
    assert (resumed["start_step"], resumed["global_step"]) == (2, 3)
    assert seen["path"] == str(ckpt) and seen["last_epoch"] == 2
    assert seen["lr"] == [fn(2), fn(2), fn(2) * 0.1]

    model, opt, sched, step = reference_loop()
    start, _ = load_train_state(str(ckpt), model, opt)
    resume_schedule(sched, start)
    step.step = start
    video, labels = next(batches_of(0))
    want = float(step(video, labels)["loss"])
    assert resumed["losses"] == [want]
    assert_same_state(resumed["model"].state_dict(), model.state_dict())
    saved = torch.load(tmp_path / "train_state_00000003.pt",
                       weights_only=True)
    assert saved["step"] == 3
    assert_same_optimizer(saved["optimizer"], opt.state_dict())


def test_final_weights_load_for_the_evaluator(tmp_path):
    """model_final.pth.tar loads with load_pretrained (as test_models
    reads it) and gives the trained model's logits."""
    got = run(base_argv(tmp_path, "--steps", "2"))
    loaded = load_pretrained(got["final_path"], device="cpu")
    video = torch.from_numpy(next(port_train.synthetic_batches(
        4, CLASSES, T, SIZE, 4, 9))[0])
    trained = got["model"].eval()
    with torch.no_grad():
        assert torch.equal(loaded(video), trained(video))
    assert loaded.num_classes == CLASSES and loaded.tier == "tiny"


def test_pretrained_replaces_the_head(tmp_path):
    """--pretrained loads the backbone and puts a new head of the run's
    class count on it (lr 0: the weights stay as loaded)."""
    model = create_rubiksnet("tiny", 7, T, device="cpu",
                             generator=torch.Generator().manual_seed(8))
    path = tmp_path / "pre.pth.tar"
    save_pretrained(model, path)
    got = run(base_argv(None, "--steps", "1", "--pretrained", str(path),
                        "--lr", "0"))
    out = got["model"]
    assert out.new_fc.weight.shape[0] == out.num_classes == CLASSES
    src = dict(model.named_parameters())
    for name, p in out.named_parameters():
        if not name.startswith("new_fc"):
            assert torch.equal(p.detach(), src[name].detach()), name


def test_options_the_port_does_not_take():
    with pytest.raises(NotImplementedError, match="data-parallel"):
        run(base_argv(None, "--data-parallel", "2"))
    for tpu_only in (["--model-parallel", "2"], ["--shift-backend", "mix"],
                     ["--scan-blocks", "on"], ["--no-remat"]):
        with pytest.raises(SystemExit):
            port_train.build_parser().parse_args(base_argv() + tpu_only)
    with pytest.raises(SystemExit):
        run(["--device", "cpu"])  # neither a dataset nor --synthetic
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_train.main(["--synthetic", "4", "--tier", "tiny"])


def test_example_finetune_runs_one_epoch():
    out = example_finetune.main(
        ["--tier", "tiny", "--frames", str(T), "--input-size", str(SIZE),
         "--train-size", "4", "--test-size", "2", "--batch-size", "2",
         "--total-epochs", "1", "--num-classes", "3", "--device", "cpu"],
        log=lambda *a: None)
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert len(out["train_acc"]) == len(out["test_acc"]) == 1


def test_example_dataset_equals_the_jax_example():
    """make_dummy_frame and ExampleVideoDataset draw as the JAX example's:
    the same frames and labels from one seed."""
    spec = importlib.util.spec_from_file_location(
        "jax_example", REPO / "scripts" / "example_finetune.py")
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    ident = np.asarray
    got = list(example_finetune.ExampleVideoDataset(4, 2, lambda f: [
        ident(x) for x in f], 3, seed=2))
    want = list(jax_example.ExampleVideoDataset(4, 2, lambda f: [
        ident(x) for x in f], 3, seed=2))
    for (gf, gl), (wf, wl) in zip(got, want):
        assert gl == wl
        for a, b in zip(gf, wf):
            np.testing.assert_array_equal(a, b)
