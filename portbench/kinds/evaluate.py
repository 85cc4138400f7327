"""Evaluating a validation list as the port's evaluator
(``scripts/test_models.py``) wires it: its ``build_dataset`` with the
device loader (nvjpeg decode, the ``resize_crop_u8`` kernel), batches made
on a side stream by ``device_batches_from_files`` inside the prefetch
thread, ``make_eval_step`` on one ``FusedExecutor`` with the pixels
normalized on the card, each batch's logits copied to the host. The loop
is ``evaluate``'s: wait for the next batch (the host-wait time is
counted), take it, step, copy.

Set-up writes ``videos`` SSv2-like videos of JPEGs from the seed into a
directory under ``TMPDIR`` (removed when the process ends), listed
``repeats`` times over so that the window never runs out. The check
decodes the videos of ``check_calls`` window batches (drawn from the
seed) with Pillow, resizes and crops them as ``frames.py`` does, and runs
the reference on them.

Traffic keys: ``batch``, ``videos``, ``frame_size`` [w, h],
``frames_per_video`` [lo, hi], ``quality``, ``repeats``, ``scale_size``,
``crop_size``, ``prefetch``, ``warmup_calls``, ``trace_calls``,
``check_calls``, ``reference_rows``.
"""

from __future__ import annotations

import argparse
import atexit
import os
import random
import shutil
import tempfile
import time

from ..compare import checks, worst_clip_rel_l2
from ..frames import decode, resize_crop, test_indices, write_videos
from ..reference import Reference, make_weights
from . import build_model

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def reference_clips(cfg, traffic, root, video_list, ids, device):
    """The reference's normalized clips (len(ids), frames, crop, crop, 3)
    of the videos ``ids``: Pillow's decode of the sampled frames, then
    ``frames.resize_crop``."""
    import numpy as np
    import torch

    f = cfg["num_frames"]
    paths = []
    for i in ids:
        name, frames, _ = video_list[i]
        paths += [os.path.join(root, name, f"{k:05d}.jpg")
                  for k in test_indices(frames, f)]
    raw = torch.from_numpy(np.stack(decode(paths))).to(device)
    crops = resize_crop(raw, traffic["scale_size"], traffic["crop_size"])
    mean = torch.tensor(MEAN, device=device)
    std = torch.tensor(STD, device=device)
    clips = (crops.float() / 255.0 - mean) / std
    return clips.reshape(len(ids), f, *clips.shape[1:])


def make_videos(cfg, traffic, seed, root):
    """The seed's videos under ``root``: (list file, [(folder, frames,
    label)])."""
    import numpy as np

    t = traffic
    return write_videos(root, np.random.default_rng(seed), t["videos"],
                        tuple(t["frame_size"]), t["frames_per_video"],
                        t["quality"], cfg["num_classes"], t["repeats"])


class Session:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        self.outputs = []  # (batch number, logits on the host)
        self.batches = self.videos = 0
        self.host_wait_s = 0.0

    def setup(self):
        import torch

        from rubiksnet_torch.data import device_batches_from_files, prefetch
        from rubiksnet_torch.models.fused_infer import FusedExecutor
        from rubiksnet_torch.scripts.test_models import build_dataset
        from rubiksnet_torch.train.steps import make_eval_step

        t, cfg = self.traffic, self.cfg
        self.root = tempfile.mkdtemp(prefix="portbench_eval_")
        atexit.register(shutil.rmtree, self.root, True)
        list_file, self.video_list = make_videos(cfg, t, self.seed,
                                                 self.root)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.weights = make_weights(cfg, gen, self.device)
        self.model = build_model(cfg, self.weights, self.device).eval()
        args = argparse.Namespace(
            dataset=None, val_list=list_file, root_path=self.root,
            image_tmpl="{:05d}.jpg", num_classes=cfg["num_classes"],
            frames=cfg["num_frames"], two_clips=False, limit=None,
            loader="device", host_normalize=False, device=str(self.device))
        dataset, _, views, _, _ = build_dataset(
            args, t["crop_size"], t["scale_size"], lambda *a: None,
            self.device)
        self.step = make_eval_step(self.model, num_crops=views,
                                   executor=FusedExecutor(self.model),
                                   normalize=(MEAN, STD))
        self.feed = prefetch(device_batches_from_files(
            dataset, t["batch"], views, cfg["num_frames"], 0, 1,
            self.device), depth=t["prefetch"])
        for _ in range(t["warmup_calls"]):
            self.call()
        self.outputs.clear()
        self.videos, self.host_wait_s = 0, 0.0

    def call(self):
        t0 = time.perf_counter()
        batch = next(self.feed)
        self.host_wait_s += time.perf_counter() - t0
        video, labels = batch.take()
        n_valid = int(batch.valid.sum())
        logits = self.step(video, labels)["logits"][:n_valid].cpu()
        self.outputs.append((self.batches, logits))
        self.batches += 1
        self.videos += n_valid

    def quantities(self, window_s, calls):
        return {"videos_per_s": self.videos / window_s,
                "host_wait_s": self.host_wait_s, "batch":
                self.traffic["batch"], "calls": calls, "window_s": window_s}

    def release(self):
        import torch

        self.feed.close()
        del self.feed, self.step, self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits):
        import torch

        t = self.traffic
        rng = random.Random(self.seed)
        picked = rng.sample(self.outputs, min(t["check_calls"],
                                              len(self.outputs)))
        n = len(self.video_list)
        wanted = sorted({(b * t["batch"] + r) % n for b, lg in picked
                         for r in range(lg.shape[0])})
        ref = Reference(self.cfg, self.weights)
        want = {}
        rows = t["reference_rows"]
        for i in range(0, len(wanted), rows):
            ids = wanted[i:i + rows]
            logits = ref.logits(reference_clips(
                self.cfg, t, self.root, self.video_list, ids, self.device),
                rows)
            want.update(zip(ids, logits))
        worst = 0.0
        for b, lg in picked:
            ids = [(b * t["batch"] + r) % n for r in range(lg.shape[0])]
            worst = max(worst, worst_clip_rel_l2(
                lg, torch.stack([want[i] for i in ids])))
        shutil.rmtree(self.root, ignore_errors=True)
        return checks({"logits_rel_l2": worst}, limits)
