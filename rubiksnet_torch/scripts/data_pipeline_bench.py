"""Host decode throughput of the port's evaluation datasets: the native
C++/libjpeg loader against PIL.

Counterpart of ``scripts/data_pipeline_bench.py``. Writes ``--videos``
synthetic SSv2-like frame folders (427x240 JPEGs, the reference's raw
frame geometry, by ``eval_throughput.generate_frames`` from ``--seed``)
and times passes over the evaluator's own datasets
(``test_models.build_dataset``: uint8 clips, normalized later on the
device) for the 1-clip protocol (scale 256, center crop 224) and the
2-clip one (two samplings x three full-resolution crops), on each loader:
videos/s, clips/s and ms a decoded frame, the best of ``--repeats``
passes. The native loader is built first; where it does not build (no g++
or no libjpeg, as on the card's machine) its rows hold the build error and
PIL's are timed all the same.

``correct``: every clip has its protocol's shape and dtype, and where both
loaders run, their clips are at most 1 apart per pixel (their resizes
round differently). A pass that fails or a wrong clip stays in the line
and the exit code is 1. The pass runs on the host alone; the device (the
card unless ``--device cpu``; it raises where there is none) is named
beside the numbers. Prints one JSON line last, also to ``--out`` when
given.

Usage: python -m rubiksnet_torch.scripts.data_pipeline_bench [--videos 24]
       [--frames 8] [--repeats 2] [--seed 0] [--device cpu] [--out FILE]
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

from ..data import native_loader
from ..models.rubiksnet import resolve_device
from ..utils import nvidia_smi_line
from . import eval_throughput, test_models

FRAME_SIZE = (427, 240)  # the reference's raw SSv2 frames, width x height
CLASSES = 4
PROTOCOLS = (("1clip", False, 1), ("2clip", True, 6))  # name, two, views
PIXEL_TOL = 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--videos", type=int, default=24)
    p.add_argument("--frames", type=int, default=8,
                   help="frames a clip (segments)")
    p.add_argument("--repeats", type=int, default=2,
                   help="passes a loader; the best is kept")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card, which raises "
                        "where there is none")
    p.add_argument("--out", default=None, help="also write the JSON here")
    return p


def dataset(root, list_file, frames, two_clips, loader):
    """The evaluator's dataset of one protocol and loader."""
    args = test_models.build_parser().parse_args(
        eval_throughput.evaluator_args(
            "unused.pth.tar", list_file, root, CLASSES, frames, 1, two_clips,
            loader=loader))
    return test_models.build_dataset(args, log=lambda *a: None)[0]


def time_passes(ds, repeats):
    """(best seconds a video, the first pass's clips)."""
    best, first = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        clips = [np.asarray(clip) for clip, _ in ds]
        best = min(best, (time.perf_counter() - t0) / len(clips))
        first = first if first is not None else clips
    return best, first


def protocol_row(root, list_file, args, two_clips, views, native_error):
    entry = {"views_per_video": views,
             "frames_decoded_per_video": args.frames * (2 if two_clips
                                                        else 1)}
    want = (views * args.frames, test_models.CROP_SIZE,
            test_models.CROP_SIZE, 3)
    clips = {}
    for loader in ("pil", "native"):
        if loader == "native" and native_error is not None:
            entry[loader] = {"built": False, "error": native_error,
                             "correct": True}
            continue
        try:
            sec, clips[loader] = time_passes(
                dataset(root, list_file, args.frames, two_clips, loader),
                args.repeats)
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
            "ms_per_frame": 1e3 * sec / entry["frames_decoded_per_video"]}
    if len(clips) == 2:
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
    try:
        native_loader.load_library()
        native_error = None
    except RuntimeError as err:
        native_error = str(err)
    result = {"metric": "host decode of the evaluation datasets",
              "device": name or dev.type, "card": card,
              "host_cores": os.cpu_count(), "videos": args.videos,
              "frames_per_clip": args.frames,
              "frame_px": f"{FRAME_SIZE[0]}x{FRAME_SIZE[1]} jpeg "
                          f"q{eval_throughput.QUALITY}",
              "native_built": native_error is None, "protocols": {}}
    root = tempfile.mkdtemp(prefix="rubiks_data_bench_")
    try:
        list_file = eval_throughput.generate_frames(
            root, args.videos, CLASSES, seed=args.seed, size=FRAME_SIZE)
        for proto, two_clips, views in PROTOCOLS:
            entry = protocol_row(root, list_file, args, two_clips, views,
                                 native_error)
            result["protocols"][proto] = entry
            for loader in ("pil", "native"):
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
                            for loader in ("pil", "native"))
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
