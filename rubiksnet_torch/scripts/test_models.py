"""Full validation-set evaluator of the PyTorch port.

Counterpart of scripts/test_models.py (the reference's evaluator): the
1-clip protocol (shorter side scaled to 256, center crop 224) and the 2-clip
protocol (twice_sample x 3 GroupFullResSample crops: 6 views), logits
averaged over the views, top-1, top-5 and per-class accuracy, in the
reference's log lines, and the same ``--stats-out`` keys.

On the card the run holds one FusedExecutor (K2 and K3 in every batch),
and each batch is staged in pinned memory and copied on a side stream one
batch ahead of the model (``data/device.py``), inside the prefetch thread.
Clips travel as uint8 and are normalized on the device, with every loader,
unless ``--host-normalize``. ``--loader device`` decodes, resizes and crops
on the card (nvjpeg and the ``resize_crop_u8`` kernel,
``data/device_loader.py``): the batch's files are read on the host and the
clips never exist there, so it refuses ``--host-normalize``. ``--loader
auto`` takes the native loader where it builds, else the device loader
where the evaluation device is a card (a failed build there raises), else
PIL. Weights come from a reference-format
``.pth.tar`` (``load_pretrained``).

Under ``torchrun`` (a world size above 1) the batch is sharded, as the JAX
evaluator shards it over its data mesh: each rank decodes and evaluates
its contiguous rows of every batch (``--batch-size`` is the global batch
and divides by the world size) through its own FusedExecutor, the logits
are gathered in order (``parallel.gather_rows``), and every rank computes
the accuracies of the whole batch; rank 0 logs.

Usage:
  python -m rubiksnet_torch.scripts.test_models somethingv2 -p ckpt.pth.tar \\
      --root-path /data [--two-clips] [--batch-size 80] [--device cpu]
  torchrun --nproc_per_node 2 -m rubiksnet_torch.scripts.test_models ...
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from ..data import (
    Compose,
    DeviceEvalDataset,
    GroupCenterCrop,
    GroupFullResSample,
    GroupNormalize,
    GroupScale,
    NativeEvalDataset,
    PrefetchIterator,
    RubiksDataset,
    Stack,
    ToClipArray,
    batch_iterator,
    device_batches,
    device_batches_from_files,
    device_loader,
    native_loader,
    prefetch,
    return_dataset,
)
from ..models import INPUT_MEAN, INPUT_STD, FusedExecutor, load_pretrained
from ..models.rubiksnet import resolve_device
from ..parallel import (
    create_mesh,
    gather_rows,
    group_rank,
    group_size,
    initialize_distributed,
    rank0_log,
)
from ..train.steps import make_eval_step
from ..utils import AverageMeter, per_class_accuracy
from ..utils.profiling import counters, recording, span_totals, spans

CROP_SIZE, SCALE_SIZE = 224, 256
DATA_NAMES = "rubiksnet.data."  # the spans and counters --stats-out keeps


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="RubiksNet testing on the full validation set")
    parser.add_argument("dataset", type=str, nargs="?", default=None,
                        help="registry dataset name; omit when giving "
                             "--val-list/--image-tmpl directly")
    parser.add_argument("-p", "--pretrained", type=str, required=True)
    parser.add_argument("--root-path", type=str, default="./")
    parser.add_argument("--val-list", type=str, default=None,
                        help="path to a '<folder> <n_frames> <label>' list "
                             "file (bypasses the dataset registry)")
    parser.add_argument("--image-tmpl", type=str, default="{:05d}.jpg",
                        help="frame filename template (with --val-list)")
    parser.add_argument("--num-classes", type=int, default=None,
                        help="class count (with --val-list)")
    parser.add_argument("--stats-out", type=str, default=None,
                        help="write an end-to-end throughput record "
                             "(videos/s, host-wait and device split) to "
                             "this JSON path")
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--two-clips", action="store_true")
    parser.add_argument("--batch-size", type=int, default=80)
    parser.add_argument("--limit", type=int, default=None,
                        help="evaluate only the first N videos")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--loader", default="auto",
                        choices=["auto", "pil", "native", "device"],
                        help="'native' uses the C++ libjpeg pipeline, "
                             "'device' nvjpeg and a CUDA resize-and-crop "
                             "kernel on the card (each raises where it "
                             "cannot be built); 'auto' picks native where "
                             "it builds, else device on a card, else pil")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="batches decoded and copied ahead on a "
                             "background thread (0 disables)")
    parser.add_argument("--backend", default="fused",
                        choices=["fused", "model"],
                        help="'fused' = one FusedExecutor for the run "
                             "(K2/K3); 'model' = the module path")
    parser.add_argument("--host-normalize", action="store_true",
                        help="normalize pixels on the host and ship "
                             "float32; the default ships raw uint8 and "
                             "normalizes on the device (4x fewer bytes)")
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card, which "
                             "raises where there is none")
    return parser


def choose_loader(args, device) -> str:
    """The loader of ``args.loader`` on ``device``: 'auto' is native where
    it builds, else device where ``device`` is a card, else pil."""
    if args.loader != "auto":
        return args.loader
    if native_loader.available():
        return "native"
    return "device" if device.type == "cuda" else "pil"


def build_dataset(args, crop_size=CROP_SIZE, scale_size=SCALE_SIZE,
                  log=print, device=None):
    """The evaluation dataset of ``args``: -> (dataset, num_classes,
    num_views, loader name, device_normalize). Its clips are
    (num_views * frames, crop, crop, 3), uint8 unless ``--host-normalize``;
    with the device loader, a :class:`DeviceEvalDataset` whose batches
    :func:`device_batches_from_files` makes on ``device`` (default
    ``args.device``, else the card).
    """
    device = (torch.device(device) if device is not None
              else resolve_device(args.device))
    loader = choose_loader(args, device)
    if loader == "device" and args.host_normalize:
        raise ValueError("--loader device makes its clips on the card: "
                         "--host-normalize cannot apply")
    if args.val_list:
        if not args.num_classes:
            raise ValueError("--val-list requires --num-classes")
        num_classes, val_list, root_path, prefix = (
            args.num_classes, args.val_list, args.root_path, args.image_tmpl)
        log(f"=> dataset: folder list {val_list}")
    else:
        if not args.dataset:
            raise ValueError("a registry dataset name or --val-list is "
                             "needed")
        num_classes, _, val_list, root_path, prefix = return_dataset(
            args.dataset, args.root_path)
        log(f"=> dataset: {args.dataset}")
    log(f"=> num_classes: {num_classes}")

    if args.two_clips:
        twice_sample, test_crops = True, 3
        cropping = GroupFullResSample(crop_size, scale_size, flip=False)
    else:
        twice_sample, test_crops = False, 1
        cropping = Compose([GroupScale(scale_size), GroupCenterCrop(crop_size)])
    num_views = test_crops * (2 if twice_sample else 1)
    log(f"=> eval mode: {'2-clip' if args.two_clips else '1-clip'}")

    device_norm = not args.host_normalize
    steps = [cropping, Stack(roll=False)]
    if not device_norm:
        steps += [ToClipArray(div=True), GroupNormalize(INPUT_MEAN, INPUT_STD)]
    dataset = RubiksDataset(
        root_path, val_list, num_segments=args.frames, new_length=1,
        image_tmpl=prefix, test_mode=True, remove_missing=True,
        transform=Compose(steps) if loader == "pil" else None,
        dense_sample=False, twice_sample=twice_sample)
    if args.limit:
        dataset.video_list = dataset.video_list[: args.limit]
    if loader == "native":
        log("=> loader: native (C++ libjpeg pipeline)")
        dataset = NativeEvalDataset(
            dataset, scale_size, crop_size, INPUT_MEAN, INPUT_STD,
            two_clips=args.two_clips,
            out_dtype="uint8" if device_norm else "float32")
    elif loader == "device":
        if device.type == "cuda":
            device_loader.load_library()  # raises where it cannot be built
        log(f"=> loader: device (nvjpeg decode, CUDA resize and crop, on "
            f"{device})")
        dataset = DeviceEvalDataset(dataset, scale_size, crop_size,
                                    two_clips=args.two_clips)
    else:
        log("=> loader: pil")
    if device_norm:
        log("=> input: raw uint8, normalized on device")
    log(f"=> videos: {len(dataset)}")
    return dataset, num_classes, num_views, loader, device_norm


def evaluate(args, crop_size=CROP_SIZE, scale_size=SCALE_SIZE, log=print):
    """Run the evaluator of ``args`` (parsed by :func:`build_parser`).

    ``crop_size`` and ``scale_size`` are the protocols' geometry (224 and
    256, the reference's). Returns {"logits" (videos, classes) float32,
    "labels", "top1", "top5", "class_accuracy", "batches", "stats"}; writes
    ``args.stats_out`` when given (rank 0 under a process group, whose
    every rank returns the same accuracies). With ``args.stats_out`` the
    run records the data path's spans (``utils.profiling.recording``), and
    the stats carry their ``span_totals`` ("spans") and the run's counts of
    the ``rubiksnet.data.*`` counters ("counters")."""
    device = resolve_device(args.device)
    initialize_distributed(device=device, log=log)
    group = create_mesh()
    rank, world = group_rank(group), group_size(group)
    log = rank0_log(log, group)
    dataset, num_classes, num_views, loader, device_norm = build_dataset(
        args, crop_size, scale_size, log, device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = load_pretrained(args.pretrained, device=device, dtype=dtype)
    log(f"=> tier: {model.tier}")
    log(f"=> variant: {model.variant}")
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device))
    log(f"=> device: {device_name}")

    executor = FusedExecutor(model) if args.backend == "fused" else None
    eval_step = make_eval_step(
        model, num_crops=num_views, executor=executor,
        normalize=(INPUT_MEAN, INPUT_STD) if device_norm else None)

    top1, top5 = AverageMeter(), AverageMeter()
    all_logits, all_labels = [], []
    t0 = time.time()
    host_wait = device_time = 0.0
    first_batch_s = None  # host + device of batch 0 (warm-up)
    seen = first_videos = batches = 0
    since, counted = time.perf_counter_ns(), counters(DATA_NAMES)
    recorded, feed = contextlib.ExitStack(), None
    try:
        if args.stats_out:
            recorded.enter_context(recording())
        if loader == "device":
            feed = device_batches_from_files(dataset, args.batch_size,
                                             num_views, args.frames, rank,
                                             world, device)
        else:
            feed = device_batches(
                batch_iterator(dataset, args.batch_size, num_views,
                               args.frames, rank=rank, world=world),
                device)
        if args.prefetch > 0:
            feed = prefetch(feed, depth=args.prefetch)
        while True:
            th0 = time.time()
            try:
                batch = next(feed)
            except StopIteration:
                break
            host_wait += time.time() - th0
            td0 = time.time()
            video, labels = batch.take()
            out = eval_step(video, labels)
            logits = out["logits"]
            n_valid = int(batch.valid.sum())
            if group is not None:
                # Every rank's valid rows lead its part, so the batch's
                # valid rows lead the gathered batch.
                logits = gather_rows(logits, group)
                labels = gather_rows(labels, group)
                n_valid = int(gather_rows(torch.tensor(
                    [n_valid], device=device), group).sum())
            logits = logits[:n_valid].cpu().numpy()
            device_time += time.time() - td0
            if first_batch_s is None:
                first_batch_s = time.time() - t0
                first_videos = n_valid
            lab = labels[:n_valid].cpu().numpy()
            all_logits.append(logits)
            all_labels.append(lab)
            preds = logits.argmax(1)
            top1.update(100.0 * float(np.mean(preds == lab)), n_valid)
            order5 = np.argsort(-logits, axis=1)[:, :5]
            top5.update(
                100.0 * float(np.mean((order5 == lab[:, None]).any(1))),
                n_valid)
            seen += n_valid
            if batches % 20 == 0:
                dt = time.time() - t0
                log(f"video {seen} done, total {seen}/{len(dataset)}, "
                    f"average {dt / max(seen, 1):.3f} sec/video "
                    f"(host-input wait {host_wait:.1f}s, device step+fetch "
                    f"{device_time:.1f}s), "
                    f"moving Prec@1 {top1.avg:.3f} Prec@5 {top5.avg:.3f}")
            batches += 1
    finally:
        if isinstance(feed, PrefetchIterator):
            feed.close()
        recorded.close()
    wall = time.time() - t0

    logits = np.concatenate(all_logits)
    labels = np.concatenate(all_labels)
    cls_acc = per_class_accuracy(labels, logits.argmax(1), num_classes)
    log("\n====================== Evaluation Complete ======================")
    log("Class accuracy:")
    log(cls_acc)
    log(f"\nAccuracy: top 1: {top1.avg:.02f}%\ttop 5: {top5.avg:.02f}%")

    # Steady state leaves out batch 0, which pays the warm-up (the kernel
    # library's load, cuDNN's choice of algorithm, the first decode).
    steady_videos = seen - first_videos
    steady_wall = wall - (first_batch_s or 0.0)
    stats = {
        "videos": seen,
        "videos_per_s": seen / max(wall, 1e-9),
        "sec_per_video": wall / max(seen, 1),
        "steady_videos_per_s": (steady_videos / max(steady_wall, 1e-9)
                                if steady_videos > 0 else None),
        "steady_sec_per_video": (steady_wall / steady_videos
                                 if steady_videos > 0 else None),
        "first_batch_s": first_batch_s or 0.0,
        "device_normalize": device_norm,
        "wall_s": wall,
        "host_wait_s": host_wait,
        "host_wait_frac": host_wait / max(wall, 1e-9),
        "device_step_fetch_s": device_time,
        "device_frac": device_time / max(wall, 1e-9),
        "two_clips": bool(args.two_clips),
        "views_per_video": num_views,
        "batch_size": args.batch_size,
        "prefetch": args.prefetch,
        "loader": loader,
        "backend": args.backend,
        "dtype": args.dtype,
        "tier": model.tier,
        "top1": top1.avg,
        "top5": top5.avg,
        "device": device_name,
    }
    if args.stats_out:
        stats["spans"] = span_totals(
            r for r in spans()
            if r.name.startswith(DATA_NAMES) and r.start_ns >= since)
        stats["counters"] = {n: c - counted.get(n, 0)
                             for n, c in counters(DATA_NAMES).items()}
    if args.stats_out and not rank:
        with open(args.stats_out, "w") as f:
            json.dump(stats, f, indent=2)
        log(json.dumps(stats))
    return {"logits": logits, "labels": labels, "top1": top1.avg,
            "top5": top5.avg, "class_accuracy": cls_acc, "batches": batches,
            "stats": stats}


def main(argv=None):
    return evaluate(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
