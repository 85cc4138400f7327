"""Decode throughput of the port's evaluation datasets: PIL and the native
C++/libjpeg loader on the host, and the device loader (nvjpeg and the
``resize_crop_u8`` kernel) on the card.

Counterpart of ``scripts/data_pipeline_bench.py``, on its frames:
:func:`make_frames` writes exactly that script's ``make_frames`` files
(427x240 JPEGs at quality 95, the reference's raw frame geometry, a
(h/8)x(w/8) base from ``RandomState(7)``, ``2 * --frames`` frames a
video). It times passes over the
evaluator's own datasets (``test_models.build_dataset``) for the 1-clip
protocol (scale 256, center crop 224) and the 2-clip one (two samplings x
three full-resolution crops), on each loader: videos/s, clips/s and ms a
decoded frame, the best of ``--repeats`` passes. PIL and native clips are
uint8 on the host (``out_dtype``: normalized later on the device; the JAX
bench timed float32 ``GroupNormalize`` on the host), the device loader's
uint8 on the card: its pass reads the files, decodes, resizes and crops a
batch of the evaluator's size (``PROTOCOLS``) at a time, the card
synchronised at the end of the pass, and reports its frames by nvjpeg
backend and its launches. The native and device loaders are built first;
where one does not build (no g++ or libjpeg, as on the card's machine; no
nvcc or nvjpeg) its rows hold the build error and the others are timed
all the same.

``correct``: every clip has its protocol's shape and dtype, native clips
are at most 1 apart from PIL's per pixel (their resizes round
differently), and the device loader's within ``device_loader.
DECODE_BOUND`` of PIL's (another decoder: mean and max per channel). A
pass that fails or a wrong clip stays in the line and the exit code is 1.
The device (the card unless ``--device cpu``, where the device loader's
plain versions run; it raises where there is none) is named beside the
numbers. Prints one JSON line last, also to ``--out`` when given.

Usage: python -m rubiksnet_torch.scripts.data_pipeline_bench [--videos 24]
       [--frames 8] [--repeats 2] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from ..data import device_batches_from_files, device_loader, native_loader
from ..models.rubiksnet import resolve_device
from ..utils import nvidia_smi_line
from . import eval_throughput, test_models

FRAME_SIZE = (427, 240)  # the reference's raw SSv2 frames, width x height
QUALITY, FRAMES_SEED = 95, 7  # scripts/data_pipeline_bench.py:29-51
TMPL = "{:05d}.jpg"
CLASSES = 4
# name, two clips, views a video, videos a device-loader batch (the
# evaluator's batches in chip_smoke.py phase 7).
PROTOCOLS = (("1clip", False, 1, 32), ("2clip", True, 6, 8))
PIXEL_TOL = 1
LOADERS = ("pil", "native", "device")


def make_frames(root, num_videos, num_frames, w=FRAME_SIZE[0],
                h=FRAME_SIZE[1], quality=QUALITY):
    """``scripts/data_pipeline_bench.py``'s frames, file for file:
    ``vid{v:03d}/{f:05d}.jpg``, a (h/8)x(w/8) base from
    ``RandomState(7)`` resized bilinear to w x h, frame f as ``(img + f %
    5) % 256``, label v % 4, the list file without a final newline.
    Returns the list file's path."""
    from PIL import Image

    rng = np.random.RandomState(FRAMES_SEED)
    lines = []
    for v in range(num_videos):
        d = os.path.join(root, f"vid{v:03d}")
        os.makedirs(d, exist_ok=True)
        base = rng.randint(0, 255, size=(h // 8, w // 8, 3), dtype=np.uint8)
        img = np.asarray(
            Image.fromarray(base).resize((w, h), Image.BILINEAR), np.uint8)
        for f in range(1, num_frames + 1):
            jitter = (img.astype(np.int16) + (f % 5)) % 256
            Image.fromarray(jitter.astype(np.uint8)).save(
                os.path.join(d, TMPL.format(f)), quality=quality)
        lines.append(f"vid{v:03d} {num_frames} {v % CLASSES}")
    list_file = os.path.join(root, "val.txt")
    with open(list_file, "w") as fh:
        fh.write("\n".join(lines))
    return list_file


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--videos", type=int, default=24)
    p.add_argument("--frames", type=int, default=8,
                   help="frames a clip (segments)")
    p.add_argument("--repeats", type=int, default=2,
                   help="passes a loader; the best is kept")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card, which raises "
                        "where there is none")
    p.add_argument("--out", default=None, help="also write the JSON here")
    return p


def dataset(root, list_file, frames, two_clips, loader, dev):
    """The evaluator's dataset of one protocol and loader."""
    args = test_models.build_parser().parse_args(
        eval_throughput.evaluator_args(
            "unused.pth.tar", list_file, root, CLASSES, frames, 1, two_clips,
            loader=loader))
    return test_models.build_dataset(args, log=lambda *a: None,
                                     device=dev)[0]


def time_passes(ds, repeats):
    """(best seconds a video, the first pass's clips)."""
    best, first = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        clips = [np.asarray(clip) for clip, _ in ds]
        best = min(best, (time.perf_counter() - t0) / len(clips))
        first = first if first is not None else clips
    return best, first


def time_device_passes(ds, repeats, batch, views, frames, dev):
    """The device loader's passes: (best seconds a video, the first pass's
    clips on the host, its launches and frames by backend). A pass reads,
    decodes, resizes and crops every batch, the card synchronised at its
    end."""
    best, first, counts = float("inf"), None, None
    for _ in range(repeats):
        device_loader.reset_counts()
        t0 = time.perf_counter()
        clips = []
        for b in device_batches_from_files(ds, batch, views, frames,
                                           device=dev):
            clips.append(b.video[:int(b.valid.sum())])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, (time.perf_counter() - t0) / len(ds))
        if first is None:
            first = [c.cpu().numpy().reshape(-1, *c.shape[2:])
                     for batch_clips in clips for c in batch_clips]
            counts = {"launches": device_loader.LAUNCHES.count,
                      "backend_frames": dict(device_loader.BACKEND_FRAMES)}
    return best, first, counts


def protocol_row(root, list_file, args, two_clips, views, batch, errors,
                 dev):
    entry = {"views_per_video": views,
             "frames_decoded_per_video": args.frames * (2 if two_clips
                                                        else 1)}
    want = (views * args.frames, test_models.CROP_SIZE,
            test_models.CROP_SIZE, 3)
    clips = {}
    for loader in LOADERS:
        if errors.get(loader) is not None:
            entry[loader] = {"built": False, "error": errors[loader],
                             "correct": True}
            continue
        extra = {}
        try:
            ds = dataset(root, list_file, args.frames, two_clips, loader,
                         dev)
            if loader == "device":
                sec, clips[loader], extra = time_device_passes(
                    ds, args.repeats, batch, views, args.frames, dev)
                extra["batch_videos"] = batch
            else:
                sec, clips[loader] = time_passes(ds, args.repeats)
        except Exception as err:  # the row stays in the line, failed
            traceback.print_exc()
            entry[loader] = {"correct": False,
                             "failure": f"{type(err).__name__}: {err}"}
            continue
        shapes_ok = all(c.shape == want and c.dtype == np.uint8
                        for c in clips[loader])
        entry[loader] = {
            "correct": shapes_ok, "sec_per_video": sec,
            "videos_per_s": 1.0 / sec, "clips_per_s": views / sec,
            "ms_per_frame": 1e3 * sec / entry["frames_decoded_per_video"],
            **extra}
    if "device" in clips and "pil" in clips:
        diff = device_loader.decode_diff(clips["device"], clips["pil"])
        entry["device"].update(diff)
        entry["device"]["correct"] = (entry["device"]["correct"]
                                      and diff["within_bound"])
    if "native" in clips and "pil" in clips:
        diff = max(int(np.abs(n.astype(np.int16) - p.astype(np.int16)).max())
                   for n, p in zip(clips["native"], clips["pil"]))
        entry["max_pixel_diff"] = diff
        entry["native"]["correct"] = (entry["native"]["correct"]
                                      and diff <= PIXEL_TOL)
        entry["native_speedup"] = (entry["pil"]["sec_per_video"]
                                   / entry["native"]["sec_per_video"])
    return entry


def run(args):
    dev = resolve_device(args.device)
    name = card = None
    if dev.type == "cuda":
        name, card = torch.cuda.get_device_name(dev), nvidia_smi_line()
    errors = {}
    builds = [("native", native_loader.load_library)]
    if dev.type == "cuda":  # on the CPU the device loader's plain versions
        builds.append(("device", device_loader.load_library))
    for loader, build in builds:
        try:
            build()
        except RuntimeError as err:
            errors[loader] = str(err)
    result = {"metric": "decode, resize and crop of the evaluation "
                        "datasets",
              "device": name or dev.type, "card": card,
              "host_cores": os.cpu_count(), "videos": args.videos,
              "frames_per_clip": args.frames,
              "frames_per_video": 2 * args.frames,
              "frame_px": f"{FRAME_SIZE[0]}x{FRAME_SIZE[1]} jpeg q{QUALITY}",
              "out_dtype": {"pil": "uint8 on the host",
                            "native": "uint8 on the host",
                            "device": f"uint8 on {dev.type}"},
              "native_built": "native" not in errors,
              "device_built": (None if dev.type != "cuda"
                               else "device" not in errors),
              "protocols": {}}
    root = tempfile.mkdtemp(prefix="rubiks_data_bench_")
    try:
        list_file = make_frames(root, args.videos, 2 * args.frames)
        for proto, two_clips, views, batch in PROTOCOLS:
            entry = protocol_row(root, list_file, args, two_clips, views,
                                 batch, errors, dev)
            result["protocols"][proto] = entry
            for loader in LOADERS:
                row = entry[loader]
                text = (f"{1e3 * row['sec_per_video']:.1f} ms/video, "
                        f"{row['ms_per_frame']:.3f} ms/frame, "
                        f"{row['clips_per_s']:.1f} clips/s"
                        if "sec_per_video" in row
                        else row.get("failure", row.get("error", "")))
                print(f"[data] {proto} {loader}: {text}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result["correct"] = all(entry[loader]["correct"]
                            for entry in result["protocols"].values()
                            for loader in LOADERS)
    return result, 0 if result["correct"] else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    result, code = run(args)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return code


if __name__ == "__main__":
    sys.exit(main())
