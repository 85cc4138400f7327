"""Finetuning example on a synthetic label-correlated dataset.

Counterpart of scripts/example_finetune.py (the reference's example): load
a pretrained RubiksNet (or start from random weights, seed 0), replace the
classifier head, and train with SGD where the shift parameters get a
reduced learning rate. The synthetic dataset encodes the label as mean
frame brightness (the same ``np.random.RandomState`` draws as the JAX
example), so the model should overfit within a few epochs: this exercises
the shift's normalized gradient end to end. Each epoch trains on
``--train-size`` clips and tests on ``--test-size``, through the train
script's feed (``scripts/train.py::DataFeed``: a background thread, pinned
copies on a side stream) and the train and eval steps it uses. The card by
default; ``--device cpu`` runs the kernels' plain versions.

Usage: python -m rubiksnet_torch.scripts.example_finetune [--tier tiny]
       [--total-epochs 100] [--pretrained-path ckpt.pth.tar] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from PIL import Image

from ..data import (
    Compose,
    GroupMultiScaleCrop,
    GroupRandomCrop,
    GroupRandomHorizontalFlip,
    Stack,
    ToClipArray,
)
from ..models import create_rubiksnet, load_pretrained
from ..models.rubiksnet import resolve_device
from ..train import make_eval_step, make_train_step, sgd_with_shift_mult
from .train import DataFeed


def make_dummy_frame(label, num_classes, rng, size=256):
    """Brightness encodes the label (the reference's
    example_finetune.py:158-172)."""
    dummy_value = label / num_classes
    img = dummy_value + rng.randn(size, size, 3) / num_classes / 10.0
    img = np.clip(img * 255, 0, 255).astype(np.uint8)
    return Image.fromarray(img)


class ExampleVideoDataset:
    def __init__(self, num_classes, num_frames, transform, total_size,
                 seed=0):
        self.num_classes = num_classes
        self.num_frames = num_frames
        self.transform = transform
        self.total_size = total_size
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        for _ in range(self.total_size):
            label = int(self.rng.randint(0, self.num_classes))
            frames = [
                make_dummy_frame(label, self.num_classes, self.rng)
                for _ in range(self.num_frames)
            ]
            yield self.transform(frames), label


def batches(ds, batch_size):
    """Full batches ``(video, labels, valid)`` of a dataset's float32 clips;
    a short remainder is dropped, as the JAX example drops it."""
    vids, labs = [], []
    for clip, label in ds:
        vids.append(np.asarray(clip, np.float32))
        labs.append(label)
        if len(vids) == batch_size:
            yield (np.stack(vids), np.asarray(labs, np.int32),
                   np.ones((batch_size,), np.float32))
            vids, labs = [], []


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num-classes", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--lr-shift-mult", type=float, default=0.1)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight-decay", type=float, default=1e-4)
    parser.add_argument("--total-epochs", type=int, default=100)
    parser.add_argument("--pretrained-path", type=str, default=None)
    parser.add_argument("--tier", type=str, default="tiny")
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--train-size", type=int, default=32 * 50)
    parser.add_argument("--test-size", type=int, default=32 * 10)
    parser.add_argument("--input-size", type=int, default=224)
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card, which "
                             "raises where there is none")
    return parser


def main(argv=None, log=print):
    """Run the example; returns {"losses" (per train batch), "train_acc",
    "test_acc" (per epoch, %), "step_s" (per train batch, the wait for it
    and the step until its loss is read), "wait_s" (the wait alone),
    "peak_memory_bytes" (None off the card)}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.pretrained_path:
        model = load_pretrained(args.pretrained_path, device=device)
        model.replace_new_fc(args.num_classes)
    else:
        log("=> no pretrained checkpoint given; training from random init")
        model = create_rubiksnet(args.tier, args.num_classes, args.frames,
                                 device=device,
                                 generator=torch.Generator().manual_seed(0))

    # The train transforms of the reference's example (no normalization).
    transform = Compose([
        GroupMultiScaleCrop(256, [1, 0.875, 0.75, 0.66]),
        GroupRandomHorizontalFlip(),
        GroupRandomCrop(args.input_size),
        Stack(),
        ToClipArray(div=True),
    ])
    optimizer = sgd_with_shift_mult(model, args.lr, args.lr_shift_mult,
                                    args.momentum, args.weight_decay)
    train_step = make_train_step(model, optimizer)
    eval_step = make_eval_step(model, num_crops=1)

    out = {"losses": [], "train_acc": [], "test_acc": [], "step_s": [],
           "wait_s": []}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for epoch in range(args.total_epochs):
        log(f"\nNew epoch: {epoch}")
        train_ds = ExampleVideoDataset(args.num_classes, args.frames,
                                       transform, args.train_size,
                                       seed=epoch)
        run_loss, correct, total = 0.0, 0, 0
        feed = DataFeed(batches(train_ds, args.batch_size), device, 2)
        t0, waited = time.perf_counter(), 0.0
        for bidx, (video, labels, _) in enumerate(feed):
            metrics = train_step(video, labels)
            loss = float(metrics["loss"])
            out["step_s"].append(time.perf_counter() - t0)
            out["wait_s"].append(feed.wait_s - waited)
            waited = feed.wait_s
            out["losses"].append(loss)
            run_loss += loss
            correct += int(float(metrics["accuracy"]) * len(labels))
            total += len(labels)
            log(f"Epoch: {epoch + 1}/{args.total_epochs} | Batch: "
                f"{bidx + 1} | Loss: {run_loss / (bidx + 1):.3f} | "
                f"Acc: {100.0 * correct / total:.2f}% ({correct}/{total})")
            t0 = time.perf_counter()
        out["train_acc"].append(100.0 * correct / max(total, 1))

        log("Testing ...")
        test_ds = ExampleVideoDataset(args.num_classes, args.frames,
                                      transform, args.test_size, seed=10_000)
        correct, total = 0, 0
        for video, labels, _ in DataFeed(batches(test_ds, args.batch_size),
                                         device, 2):
            hits = eval_step(video[:, None], labels)["top1"]
            correct += int(hits.sum())
            total += len(labels)
        out["test_acc"].append(100.0 * correct / max(total, 1))
        log(f"\nFinal Acc for epoch {epoch}: "
            f"{100.0 * correct / max(total, 1):.2f}% ({correct}/{total})")
    out["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else None)
    return out


if __name__ == "__main__":
    main()
