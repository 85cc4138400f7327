"""End-to-end evaluator throughput on synthetic frame folders.

Counterpart of scripts/eval_throughput.py: writes a seeded SSv2-like
validation set (340x256 JPEGs at quality 87, smooth low-frequency content
that decodes like natural video; ``--frames-per-video`` frames a video,
default 16: the JAX script's files byte for byte; 0 draws 24-48 a video,
the frames of ``chip_smoke.py``'s evaluator phase), saves a
random-weight checkpoint of ``--tier`` (seed 0), and runs the port's
evaluator (``test_models.evaluate``) on it once for 1 clip and once for 2
clips: decode, transform, prefetch, the pinned copy on a side stream, the
fused executor. Prints videos/s, s/video and the host-wait share of each,
with the device's name; the reference's eval logs read 0.008 (1 clip) and
0.024 (2 clips) s/video for Large on an unspecified GPU.
:func:`generate_registry` writes the same videos in the ``somethingv2``
registry layout, for the training script.

Usage: python -m rubiksnet_torch.scripts.eval_throughput [--videos 96]
       [--frames-per-video 16] [--loader device] [--device cpu]
       [--out stats.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

TMPL = "{:05d}.jpg"
REGISTRY_TMPL = "{:06d}.jpg"  # somethingv2's frame names (data/config.py)
FRAME_W, FRAME_H, QUALITY = 340, 256, 87
FRAMES_PER_VIDEO = (24, 48)
REFERENCE_SEC_PER_VIDEO = {"1clip": 0.008, "2clip": 0.024}


def write_video(folder, rng, tmpl=TMPL, size=(FRAME_W, FRAME_H),
                frames=None):
    """One SSv2-like video in ``folder``: ``frames`` frames (None: 24-48,
    drawn from ``rng`` first), JPEGs of ``size`` (width, height; default
    340x256) at quality 87 named by ``tmpl`` from 1. Returns the frame
    count."""
    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    if frames is None:
        frames = int(rng.randint(FRAMES_PER_VIDEO[0],
                                 FRAMES_PER_VIDEO[1] + 1))
    base = rng.randint(0, 200, (8, 11, 3)).astype(np.uint8)
    img = np.asarray(Image.fromarray(base).resize(size, Image.BILINEAR))
    for f in range(1, frames + 1):
        jitter = rng.randint(-10, 10, (1, 1, 3))
        frame = np.clip(img.astype(np.int16) + jitter, 0, 255)
        Image.fromarray(frame.astype(np.uint8)).save(
            os.path.join(folder, tmpl.format(f)), quality=QUALITY)
    return frames


def generate_frames(root, videos, num_classes, seed=0,
                    size=(FRAME_W, FRAME_H), frames_per_video=None):
    """``videos`` frame folders ``vid00000/00001.jpg ...`` under ``root``
    (frames of ``size``, :func:`write_video`; ``frames_per_video`` a video,
    None to draw 24-48) and their list file ``root/val.txt`` (``<folder>
    <frames> <label>``). With a frame count and the default size these are
    scripts/eval_throughput.py's files. Returns the list file's path."""
    rng = np.random.RandomState(seed)
    lines = []
    for vi in range(videos):
        name = f"vid{vi:05d}"
        frames = write_video(os.path.join(root, name), rng, size=size,
                             frames=frames_per_video)
        lines.append(f"{name} {frames} {vi % num_classes}")
    list_file = os.path.join(root, "val.txt")
    with open(list_file, "w") as f:
        f.write("\n".join(lines) + "\n")
    return list_file


def generate_registry(root, train_videos, val_videos, num_classes, seed=0):
    """The ``somethingv2`` layout of ``data/config.py`` under ``root``,
    from ``seed``: ``somethingv2/label/category.txt`` (``num_classes``
    lines), ``train_videofolder.txt`` and ``val_videofolder.txt``
    (``<id> <frames> <label>``, ids 1, 2, ... with the train videos
    first), and ``somethingv2/rgb/<id>/000001.jpg ...``, every video as
    :func:`write_video` writes it, video i labelled i % num_classes.
    Returns ``root``, for ``--root``."""
    base = os.path.join(root, "somethingv2")
    label_dir = os.path.join(base, "label")
    os.makedirs(label_dir, exist_ok=True)
    with open(os.path.join(label_dir, "category.txt"), "w") as f:
        f.write("".join(f"class {k}\n" for k in range(num_classes)))
    rng = np.random.RandomState(seed)
    vid = 0
    for split, count in (("train", train_videos), ("val", val_videos)):
        lines = []
        for _ in range(count):
            vid += 1
            frames = write_video(os.path.join(base, "rgb", str(vid)), rng,
                                 REGISTRY_TMPL)
            lines.append(f"{vid} {frames} {(vid - 1) % num_classes}")
        with open(os.path.join(label_dir, f"{split}_videofolder.txt"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def evaluator_args(ckpt, list_file, root, num_classes, frames, batch_size,
                   two_clips, dtype="bfloat16", loader="auto", prefetch=2,
                   device=None, stats_out=None):
    """The evaluator's argument list for a generated set."""
    argv = ["-p", ckpt, "--val-list", list_file, "--root-path", root,
            "--image-tmpl", TMPL, "--num-classes", str(num_classes),
            "--frames", str(frames), "--batch-size", str(batch_size),
            "--dtype", dtype, "--loader", loader, "--prefetch",
            str(prefetch), "--backend", "fused"]
    if two_clips:
        argv.append("--two-clips")
    if device is not None:
        argv += ["--device", device]
    if stats_out is not None:
        argv += ["--stats-out", stats_out]
    return argv


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None,
                   help="write both protocols' stats to this JSON path")
    p.add_argument("--tier", default="large")
    p.add_argument("--videos", type=int, default=96)
    p.add_argument("--frames-per-video", type=int, default=16,
                   help="frames written a video (scripts/eval_throughput."
                        "py's default); 0 draws 24-48 a video")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--num-classes", type=int, default=174)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--loader", default="auto",
                   choices=["auto", "pil", "native", "device"])
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card")
    p.add_argument("--keep", action="store_true",
                   help="keep the generated frame root")
    args = p.parse_args(argv)

    import torch

    from ..models import create_rubiksnet, save_pretrained
    from . import test_models

    work = tempfile.mkdtemp(prefix="rubiks_eval_tp_")
    try:
        t0 = time.time()
        list_file = generate_frames(work, args.videos, args.num_classes,
                                    frames_per_video=args.frames_per_video
                                    or None)
        print(f"=> generated {args.videos} videos in {time.time() - t0:.1f}s")
        model = create_rubiksnet(args.tier, args.num_classes, args.frames,
                                 max_shift=1, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
        ckpt = os.path.join(work, "model.pth.tar")
        save_pretrained(model, ckpt)
        results = {}
        for mode in ("1clip", "2clip"):
            run = test_models.build_parser().parse_args(evaluator_args(
                ckpt, list_file, work, args.num_classes, args.frames,
                args.batch_size, mode == "2clip", loader=args.loader,
                device=args.device))
            results[mode] = test_models.evaluate(run)["stats"]
        out = {
            "synthetic_set": {
                "videos": args.videos,
                "frames_per_video": (args.frames_per_video
                                     or list(FRAMES_PER_VIDEO)),
                "resolution": f"{FRAME_W}x{FRAME_H} jpeg q{QUALITY}",
            },
            "tier": args.tier,
            "modes": results,
            "reference_sec_per_video": dict(
                REFERENCE_SEC_PER_VIDEO,
                source="reference eval logs (BASELINE.md), unspecified GPU"),
        }
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=2)
        for mode, st in results.items():
            print(f"{mode}: {st['sec_per_video']:.5f} s/video, steady "
                  f"{st['steady_videos_per_s']} videos/s, host-wait share "
                  f"{st['host_wait_frac']:.3f} on {st['device']} (reference "
                  f"{REFERENCE_SEC_PER_VIDEO[mode]} s/video, unspecified "
                  f"GPU)")
        return out
    finally:
        if not args.keep:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
