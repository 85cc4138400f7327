"""Training entry point of the PyTorch port: dataset -> prefetch -> the card
-> train step -> checkpoint/resume -> validation.

Counterpart of scripts/train.py, on one device:

  * registry datasets (``data/config.py``) or ``--synthetic N``, a
    data-free run on label-correlated random clips (the same
    ``np.random.RandomState`` draws as the JAX script);
  * the registry path samples random segments (``RubiksDataset(
    random_shift=True, seed=--seed)``) and applies GroupMultiScaleCrop,
    a random flip and a random crop; python's ``random``, which those
    transforms draw from, is seeded with ``--seed`` (the JAX script leaves
    it unseeded). Clips leave the host as uint8 and are divided by 255 in
    float32 on the device, which gives the host's ``ToClipArray(div=True)``
    bit for bit (tests/test_torch_train_script.py);
  * batches are decoded on a background thread (``--prefetch-depth``), and
    staged in pinned memory and copied on a side stream there
    (``data/device.py``), one batch ahead of the step;
  * SGD with the reduced shift learning rate (``sgd_with_shift_mult``), a
    constant or cosine schedule with warmup (``train/optim.py::
    lr_schedule``, equal to the JAX script's optax schedules), float32;
  * ``train_state_{step:08d}.pt`` checkpoints (model, momentum buffers,
    step) every ``--save-every`` steps and at the end; ``--resume`` loads
    the latest and continues the global step and the schedule, while the
    data starts again at the first batch of epoch 0, as in the JAX script;
    the final weights as ``model_final.pth.tar`` (``save_pretrained``),
    which ``load_pretrained`` and ``test_models`` read;
  * validation (top-1, top-5) on the module path every ``--val-every``
    steps or at each epoch's end, and every ``--log-every`` steps a line
    with loss, accuracy, clips/s and the share of the steps' wall clock
    spent waiting for the next batch.

The card by default; ``--device cpu`` runs the kernels' plain versions.
The JAX script's TPU options are not accepted: ``--model-parallel`` (a
tensor-parallel mesh axis), ``--shift-backend`` (the TPU shift
formulations; the port has one kernel per op), ``--scan-blocks`` and
``--no-remat`` (the TPU compiler's graph size and memory).
``--data-parallel`` above 1 raises until the port has data parallelism.

Examples:
  python -m rubiksnet_torch.scripts.train --synthetic 512 --tier tiny \\
      --input-size 64 --batch-size 8 --steps 50 --checkpoint-dir /tmp/run1
  python -m rubiksnet_torch.scripts.train somethingv2 --root /data/ssv2 \\
      --pretrained ckpts/rubiks3d_large.pth.tar --batch-size 64 --epochs 5
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import re
import time

import numpy as np
import torch

from ..data import (
    Compose,
    GroupCenterCrop,
    GroupMultiScaleCrop,
    GroupRandomCrop,
    GroupRandomHorizontalFlip,
    GroupScale,
    PrefetchIterator,
    RubiksDataset,
    Stack,
    batch_iterator,
    device_batches,
    prefetch,
    return_dataset,
)
from ..models import create_rubiksnet, load_pretrained, save_pretrained
from ..models.rubiksnet import resolve_device
from ..train import (
    load_train_state,
    lr_schedule,
    make_eval_step,
    make_train_step,
    resume_schedule,
    save_train_state,
    sgd_with_shift_mult,
)
from ..utils import AverageMeter
from ..utils.profiling import step_stats


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("dataset", nargs="?", default=None,
                   help="registry dataset name (data/config.py); omit with "
                        "--synthetic")
    p.add_argument("--root", default=None, help="dataset root path")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="train on N label-correlated synthetic clips per "
                        "epoch instead of a registry dataset")
    p.add_argument("--tier", default="large",
                   choices=["tiny", "small", "medium", "large"])
    p.add_argument("--variant", default="rubiks3d",
                   choices=["rubiks3d", "rubiks3d-aq"])
    p.add_argument("--pretrained", default=None,
                   help=".pth.tar checkpoint to start from (the "
                        "classifier head is replaced)")
    p.add_argument("--num-classes", type=int, default=10,
                   help="class count (synthetic mode; registry datasets "
                        "override)")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--input-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps", type=int, default=0,
                   help="stop after this many optimizer steps (0 = run the "
                        "full --epochs)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--total-steps", type=int, default=0,
                   help="cosine horizon (defaults to --steps or "
                        "epochs * len(dataset) / batch)")
    p.add_argument("--lr-shift-mult", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--data-parallel", type=int, default=0, metavar="D",
                   help="devices to train on; one (0 or 1) until the port "
                        "has data parallelism")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--save-every", type=int, default=500, metavar="STEPS")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--val-every", type=int, default=0, metavar="STEPS",
                   help="run validation every N steps (0 = each epoch end)")
    p.add_argument("--val-size", type=int, default=0,
                   help="cap validation to this many clips (0 = all)")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="batches prepared ahead on a background thread "
                        "(0: none)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card, which raises "
                        "where there is none")
    return p


def synthetic_batches(n_clips, num_classes, frames, size, batch, seed):
    """Label-correlated random clips, generated directly as arrays (the
    brightness-encodes-label scheme of example_finetune.py without the PIL
    round-trip): the JAX script's draws, float32 in [0, 1]."""
    rng = np.random.RandomState(seed)
    steps = n_clips // batch
    for _ in range(steps):
        labels = rng.randint(0, num_classes, size=(batch,)).astype(np.int32)
        base = labels.astype(np.float32) / num_classes
        noise = rng.randn(batch, frames, size, size, 3).astype(np.float32)
        video = base[:, None, None, None, None] + noise / num_classes / 10.0
        yield np.clip(video, 0.0, 1.0), labels


def checkpoint_path(ckpt_dir, step):
    return os.path.join(ckpt_dir, f"train_state_{step:08d}.pt")


def latest_checkpoint(ckpt_dir):
    best = None
    for path in glob.glob(os.path.join(ckpt_dir, "train_state_*.pt")):
        m = re.search(r"train_state_(\d+)\.pt$", path)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), path)
    return best[1] if best else None


def train_transforms(input_size):
    """The JAX script's train transforms up to the uint8 clip; the division
    by 255 happens on the device (:func:`to_unit`)."""
    return Compose([
        GroupMultiScaleCrop(256, [1, 0.875, 0.75, 0.66]),
        GroupRandomHorizontalFlip(),
        GroupRandomCrop(input_size),
        Stack(),
    ])


def val_transforms(input_size):
    """The JAX script's validation transforms up to the uint8 clip."""
    return Compose([
        GroupScale(int(input_size * 256 / 224)),
        GroupCenterCrop(input_size),
        Stack(),
    ])


def to_unit(video):
    """A clip tensor as float32 in [0, 1]: uint8 divided by 255 (the same
    float32 division as ``ToClipArray(div=True)`` on the host), float32 as
    it is."""
    return video.float() / 255.0 if video.dtype == torch.uint8 else video


class DataFeed:
    """``(video, labels, valid)`` host batches on ``device``: decoded and
    copied ``depth`` batches ahead on a background thread (none at depth
    0), staged in pinned memory and copied on a side stream on the card
    (``data.device_batches``). Iterating yields ``(video, labels, valid)``
    with video float32 in [0, 1] and labels int64, ready on the current
    stream; ``wait_s`` adds up the time spent waiting for them."""

    def __init__(self, batches, device, depth):
        self.feed = device_batches(batches, device)
        if depth > 0:
            self.feed = prefetch(self.feed, depth=depth)
        self.wait_s = 0.0

    def __iter__(self):
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(self.feed)
                except StopIteration:
                    return
                video, labels = batch.take()
                self.wait_s += time.perf_counter() - t0
                yield to_unit(video), labels.long(), batch.valid
        finally:
            if isinstance(self.feed, PrefetchIterator):
                self.feed.close()


def build_data(args):
    """-> (num_classes, steps_per_epoch, train_epoch_iter(epoch),
    val_iter()), the iterators yielding host ``(video, labels, valid)``
    batches: float32 clips for --synthetic, uint8 for a registry dataset."""
    if args.synthetic:
        num_classes = args.num_classes
        steps_per_epoch = max(args.synthetic // args.batch_size, 1)

        def train_epoch_iter(epoch):
            for video, labels in synthetic_batches(
                    args.synthetic, num_classes, args.frames,
                    args.input_size, args.batch_size, seed=args.seed + epoch):
                yield video, labels, np.ones((len(labels),), np.float32)

        def val_iter():
            for video, labels in synthetic_batches(
                    max(args.val_size, args.batch_size), num_classes,
                    args.frames, args.input_size, args.batch_size,
                    seed=args.seed + 10_000):
                yield video, labels, np.ones((len(labels),), np.float32)

        return num_classes, steps_per_epoch, train_epoch_iter, val_iter

    num_classes, train_list, val_list, root, tmpl = return_dataset(
        args.dataset, args.root or ".")
    train_ds = RubiksDataset(
        root, train_list, num_segments=args.frames, image_tmpl=tmpl,
        transform=train_transforms(args.input_size), random_shift=True,
        seed=args.seed)
    val_ds = RubiksDataset(
        root, val_list, num_segments=args.frames, image_tmpl=tmpl,
        transform=val_transforms(args.input_size), random_shift=False)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)

    def train_epoch_iter(epoch):
        for video, labels, valid in batch_iterator(
                train_ds, args.batch_size, num_crops=1,
                num_frames=args.frames, drop_remainder=True):
            yield video[:, 0], labels, valid

    def val_iter():
        count = 0
        for video, labels, valid in batch_iterator(
                val_ds, args.batch_size, num_crops=1,
                num_frames=args.frames):
            yield video[:, 0], labels, valid
            count += int(valid.sum())
            if args.val_size and count >= args.val_size:
                return

    return num_classes, steps_per_epoch, train_epoch_iter, val_iter


def build_model(args, num_classes, device):
    """A float32 model: ``--pretrained`` with a new head of
    ``num_classes``, or random weights from ``--seed``."""
    if args.pretrained:
        model = load_pretrained(args.pretrained, device=device)
        return model.replace_new_fc(
            num_classes, generator=torch.Generator().manual_seed(args.seed))
    return create_rubiksnet(
        args.tier, num_classes, args.frames, args.variant, device=device,
        generator=torch.Generator().manual_seed(args.seed))


def validate(eval_step, batches, log, step):
    """Top-1 and top-5 over the valid clips of ``batches``; -> (top1 %,
    top5 %, clips, batches)."""
    top1_m, top5_m = AverageMeter(), AverageMeter()
    count = 0
    for video, labels, valid in batches:
        out = eval_step(video[:, None], labels)
        v = torch.as_tensor(valid, device=video.device)
        n = max(int(valid.sum()), 1)
        top1_m.update(float((out["top1"] * v).sum()) / n, n)
        top5_m.update(float((out["top5"] * v).sum()) / n, n)
        count += 1
    log(f"[val @ step {step}] top1 {top1_m.avg * 100:.2f}% "
        f"top5 {top5_m.avg * 100:.2f}% ({top1_m.count} clips)")
    return top1_m.avg * 100, top5_m.avg * 100, top1_m.count, count


def train(args, log=print, after_resume=None):
    """Run the training of ``args`` (parsed by :func:`build_parser`).

    ``after_resume(model, optimizer, scheduler, path)`` is called right
    after ``--resume`` loaded ``path``. Returns {"start_step",
    "global_step", "losses", "accuracies", "wait_s", "step_s" (per step,
    the wait for its batch and the step until its loss is read), "wall_s",
    "host_wait_frac" (the wait's share of the wall clock of the steps
    after the first, as ``utils.profiling.step_stats`` reads it; validation
    and checkpoints left out), "val" [(step, top1, top5, clips)],
    "val_batches", "final_path", "checkpoint", "peak_memory_bytes" (None
    off the card), "device", "model"}."""
    if not args.synthetic and not args.dataset:
        raise SystemExit("either a registry dataset name or --synthetic N "
                         "is required")
    if args.data_parallel > 1:
        raise NotImplementedError(
            "--data-parallel > 1: the port trains on one device until it "
            "has data parallelism")
    device = resolve_device(args.device)
    random.seed(args.seed)
    num_classes, steps_per_epoch, train_epoch_iter, val_iter = build_data(
        args)
    model = build_model(args, num_classes, device)
    total_steps = args.total_steps or args.steps or (
        args.epochs * steps_per_epoch)
    optimizer, scheduler = sgd_with_shift_mult(
        model, lr_schedule(args.lr_schedule, args.lr, args.warmup_steps,
                           total_steps),
        args.lr_shift_mult, args.momentum, args.weight_decay)
    train_step = make_train_step(model, optimizer, scheduler)
    eval_step = make_eval_step(model, num_crops=1)

    start_step = 0
    if args.resume:
        if not args.checkpoint_dir:
            raise ValueError("--resume requires --checkpoint-dir")
        path = latest_checkpoint(args.checkpoint_dir)
        if path:
            start_step, meta = load_train_state(path, model, optimizer)
            resume_schedule(scheduler, start_step)
            train_step.step = start_step
            log(f"=> resumed {path} (step {start_step}, meta {meta})")
            if after_resume is not None:
                after_resume(model, optimizer, scheduler, path)
        else:
            log("=> --resume: no checkpoint found, starting fresh")

    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device))
    log(f"device: {device_name} | tier={model.tier} "
        f"variant={model.variant} classes={num_classes} "
        f"bs={args.batch_size} schedule={args.lr_schedule}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    result = {"start_step": start_step, "losses": [], "accuracies": [],
              "wait_s": [], "step_s": [], "val": [], "val_batches": 0,
              "checkpoint": None, "final_path": None, "device": device_name,
              "model": model}

    def run_validation(step):
        *metrics, batches = validate(
            eval_step, DataFeed(val_iter(), device, args.prefetch_depth),
            log, step)
        result["val"].append((step, *metrics))
        result["val_batches"] += batches

    def maybe_save(step, epoch):
        if args.checkpoint_dir:
            os.makedirs(args.checkpoint_dir, exist_ok=True)
            path = checkpoint_path(args.checkpoint_dir, step)
            save_train_state(
                path, model, optimizer, step,
                metadata={"tier": model.tier, "variant": model.variant,
                          "num_classes": num_classes, "epoch": epoch,
                          "frames": args.frames,
                          "input_size": args.input_size})
            result["checkpoint"] = path
            log(f"=> saved checkpoint @ step {step}")

    step = start_step
    done = False
    t_run = time.perf_counter()
    loss_m = AverageMeter()
    for epoch in range(args.epochs):
        if done:
            break
        loss_m, acc_m = AverageMeter(), AverageMeter()
        feed = DataFeed(train_epoch_iter(epoch), device, args.prefetch_depth)
        t_log, c_log, i_log = time.perf_counter(), 0, len(result["step_s"])
        waited = 0.0
        t0 = time.perf_counter()
        for video, labels, _ in feed:
            metrics = train_step(video, labels)
            loss, acc = float(metrics["loss"]), float(metrics["accuracy"])
            result["step_s"].append(time.perf_counter() - t0)
            result["wait_s"].append(feed.wait_s - waited)
            waited = feed.wait_s
            result["losses"].append(loss)
            result["accuracies"].append(acc)
            step += 1
            loss_m.update(loss, len(labels))
            acc_m.update(acc, len(labels))
            c_log += len(labels)
            if step % args.log_every == 0:
                dt = time.perf_counter() - t_log
                wait = sum(result["wait_s"][i_log:])
                busy = sum(result["step_s"][i_log:])
                log(f"epoch {epoch + 1}/{args.epochs} step {step} | "
                    f"loss {loss_m.avg:.4f} acc {acc_m.avg * 100:.2f}% | "
                    f"{c_log / max(dt, 1e-9):.1f} clips/s | host-wait "
                    f"{wait / max(busy, 1e-9):.3f}")
                t_log, c_log = time.perf_counter(), 0
                i_log = len(result["step_s"])
            if args.save_every and step % args.save_every == 0:
                maybe_save(step, epoch)
            if args.val_every and step % args.val_every == 0:
                run_validation(step)
            if args.steps and step - start_step >= args.steps:
                done = True
                break
            t0 = time.perf_counter()
        if not args.val_every:
            run_validation(step)
    if args.checkpoint_dir and result["checkpoint"] != checkpoint_path(
            args.checkpoint_dir, step):
        maybe_save(step, args.epochs - 1)
    if args.checkpoint_dir:
        final = os.path.join(args.checkpoint_dir, "model_final.pth.tar")
        save_pretrained(model, final)
        result["final_path"] = final
        log(f"=> saved final weights to {final}")
    log(f"done: {step - start_step} steps this run (global step {step}), "
        f"final loss {loss_m.avg:.4f}")
    result.update(
        global_step=step, wall_s=time.perf_counter() - t_run,
        host_wait_frac=(step_stats(result["step_s"], result["wait_s"],
                                   args.batch_size)["host_wait_frac"]
                        if result["step_s"] else 0.0),
        peak_memory_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None))
    return result


def main(argv=None):
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
