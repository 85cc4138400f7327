#!/usr/bin/env python3
"""Smoke run of the PyTorch port of RubiksNet on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 shift3d, K1-inverse shift3d_inverse and
K4 shift_grad on their staged route shift3d_bwd.cu, K2 fused_block with
its tensor-core launches fused_block_tc.cu,
K3 fused_entry with its tensor-core launches fused_entry_tc.cu, the SE gate
inside K2 and K3: in bf16 its sums in launch A, tc_se.cuh, and one gate launch,
se_gate_tc.cu, in f32 se_gate.cuh's two launches; the 2D shift's forward and
input gradient, shift2d.cu; the train-mode BN and ReLU pair,
bn_relu_train.cu, held at every BN shape of a Large train step at batch 32 and
timed there; and the fused executor's stem, stem.cu, held in bf16 and f32 at
224 px for batch 1, 8 and 64, at 112 px, odd sizes and Tiny's width 54, each
run twice bit-identically, and timed at batch 8 beside cuDNN) from
rubiksnet_torch/ops/csrc, holds each against its plain
PyTorch version at every shape of its path (K2 and K3 also off the model's
shapes, and in bf16 at every batch size they are timed or served at,
because their launch plans depend on the batch: a K2 or K3 plan that did
not pass that comparison is not timed): RubiksNet-Large
(rubiks3d), Large with the rubiks3d-aq variant (the 2D shift kernels, K2
and K3 with the attention mix) and the SE tier Small (K2 and K3 with the gate;
every SE comparison also holds the gate alone against the plain gate of the
kernel's own mid, and Small with the rubiks3d-aq variant is checked in f32
and bf16 at a small size).
For each of the three models it checks the logits (fused executor and
unfused module path against the plain model), counts the kernel launches of
one fused and one unfused forward, and times serving at batch sizes 1, 8
and 32 (bf16, 8 frames, 224x224). Then it trains: a tiny synthetic overfit
through the kernels, one Large f32 train step through the kernels against
the same step on the plain shift, the launches of one bf16 train step of
each model, and train throughput (Large at batch 8, 16 and 32, Large-AQ
and Small at batch 8). Before training, phase 7: the device loader
(rubiksnet_torch.data.device_loader: nvjpeg and the resize_crop_u8 kernel,
built with the kernels, in parallel): (a) nvjpeg's probe and the frames
by decode route; (c) nvjpeg against Pillow on frames of six sizes within
DECODE_BOUND; (b) resize_crop_u8 (its staged kernel) against its plain
version on that decode, 1 and 3
crops, upscales, downscales of every ksize and a portrait frame,
bit-identical; then the evaluator (rubiksnet_torch.scripts.
test_models) end to end on RubiksNet-Large in bf16 over 64 synthetic
SSv2-like videos (340x256, which the loaders crop without resizing), 1-clip
at batch 32 and 2-clip at batch 8, (d) with --loader device and (e) with
the host's loader (native where g++ finds libjpeg, else PIL), each at
--prefetch 2 and 0, then (d) again over 64 videos of the data bench's
427x240 frames, which the device loader resizes: K2's and K3's plans at
its 32 and 48 clips checked first, its launches counted (the stem, 47 K2
and 4 K3 a batch, one resize_crop_u8 a batch with the device loader, one executor a
run), each loader's first batch against the plain model, each loader's
logits bit-identical across prefetch depths, (f) the two loaders' logits
compared (informational), and each run's s/video, steady videos/s and
host-wait share printed; resize_crop_u8 timed at the evaluator's three
shapes (1-clip of 427x240 and of 340x256, 2-clip of 427x240) beside its
plain version, the library's interpolate or sliced
copy and the bound. Last, the
training entry points as a user runs them
(phase 9; RubiksNet-Large in float32, 8x224x224, batch 8):
rubiksnet_torch.scripts.train on 48 synthetic clips (cosine schedule with
warmup, checkpoints every 2 steps, validation at step 4), then --resume
for 2 more steps (global step 6; right after the load the parameters,
statistics, momentum buffers and lr equal the step-4 checkpoint's bit for
bit); train somethingv2 over 128 synthetic SSv2-like videos, 16 steps
(the training data path: random segments, GroupMultiScaleCrop, flip,
crop, PIL decode on the prefetch thread, uint8 to the card); test_models on that run's
model_final.pth.tar (bf16, 1-clip, the first batch against the plain
model); example_finetune; each run's launches counted (51 K1, K1-inverse
and K4 a train step, 51 K1 a validation batch) and, over the steps after
the first, its median step, clips/s and host-wait share printed (marked
not steady under 3 such steps), with its first step and peak memory;
then Large bf16 at 112 px through the fused executor (the last entry, at
7x7, on the module path; logits against the plain model), Small bf16 at
the default max_shift (4) at batch 1, 8 and 32 (the steps whose SE gate
does not fit K2's or K3's shared memory on the module path, printed;
launches by the route; logits against the plain model) and the SE
shared-memory rule of fused_*_supported at its edge (declined: the C side
refuses the launch; one step inside: the kernel runs and agrees with
plain). Then phase 10, serving export (rubiksnet_torch.serving, bf16,
8x224x224, 1 crop): Large through the fused executor at batch 8 and at a
symbolic batch n in [1, 32], Large on the module path at 8, Large-AQ and
Small fused at 8, each exported with torch.export, saved, then loaded and
run in one fresh process that imports rubiksnet_torch.serving and builds
no model, its launches counted there (the kernels are the rubiksnet::
operators of ops/library.py) and its logits held against the live route
(equal, or within rel-L2 1e-3 with a line saying why) and the plain model;
then the exported Large programs timed beside the live executor at batch
1, 8 and 32. Last, phase 11, parallelism (rubiksnet_torch.parallel): two
ranks spawned on the one card, which share it through gloo: (a) a DDP
train step of Large in f32 at 4 clips a rank against one process at 8
from one state (loss, gradients, BN statistics; 51 K1, K1-inverse and K4
a rank), (b) Large and Large-AQ bf16 eval at batch 8 with T 8 over the
two ranks (halo exchange, the module path) against the unsharded module
path, (c) the temporal shift op (halo, K1, K1-inverse, K4) at Large's
five stage shapes against the unsharded kernels, fractional and
quantized, f32 and bf16, (d) test_models with the batch sharded against
one process, every collective on CUDA tensors through gloo; then one
NCCL rank at world size 1 takes a DDP step. Its times (DDP step, sharded eval
batch, the halo's cat, trim and exchange) stand beside the one-process
figures and describe the code path on one shared card, not a multi-card
run. Then phase 12, tensor parallelism (the model group of
rubiksnet_torch.parallel): two ranks spawned on the card, through gloo, a
1 x 2 data x model mesh, Large sharded by JAX's default partition (79
weights: the largest 1x1 convs and new_fc): (a) one f32 train step at
batch 8 against one process from one state (loss and BN statistics
within 1e-6, every gradient gathered within 5e-2, the replicated
gradients bit-identical on both ranks, and which of them differed before
the step's broadcast), (b) its launches and collectives a rank (51 K1,
K1-inverse and K4, 79 channel gathers, 79 model-group all-reduces),
(c) its time beside one process's, (d) Large-AQ bf16 eval at batch 8
under the model group against unsharded (51 2D shifts, 79 gathers a
rank), (e) train.py --model-parallel 2 --synthetic for 2 steps, its
checkpoint loaded in one process equal to the gathered state; its times
describe the code path on one shared card too. Last, phase 13, the
measurement entry points in this process (rubiksnet_torch.scripts.bench,
shift_microbench, data_pipeline_bench): Large bf16 serving through the
fused executor at batch 8 and 64 (K2's and K3's plans at 64 held against
plain first) and a Large bf16 train step at batch 8, each line correct,
its launches a call those of the phases above, its mfu and busy share in
(0, 1]; the shift microbench at 14x14x288, batch 64, every mode and route
(kernel, plain, library) held against plain; the data-pipeline bench over
8 videos, the native
loader built exactly where the toolchain probe says it can be, the device
loader built, its row within DECODE_BOUND of PIL's. Every
process it starts (nvcc, the ranks, the serving process) is waited for,
and it checks that none is left before the result lines. Fails (non-zero
exit, no result line) on the first problem, and without a CUDA device.

The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel results as {"kernels": [...]}: for each kernel its launches
on its main path, its error against the plain version, its time beside the
plain version's, its bound (the larger of bytes moved over the memory rate
and operations over the peak rate, from the shapes) and the time of the
one PyTorch library call that computes the same function, where one
exists (a depthwise convolution for the shifts); the rows of the kernels
on phase 11's and phase 12's paths also carry their launches a rank there
(parallel_launches, tensor_parallel_launches); the last row is the
device loader's resize_crop_u8 (its launches those of phase 7's device
runs; its times and the library's version at three shapes: the row's own
keys at a 1-clip batch of 427x240 frames, which it resizes, copy_* at one
of the evaluator's 340x256 frames, only cropped, clip2_* at the 2-clip
batch of 427x240, 3 crops a frame). K1's, K1-inverse's and K4's rows,
K2's three, K3's three and the 2D shift's two carry their device time by
the profiler; K2's also the time of a forward's blocks as the models call
them, one run per stage. The SE gate's row (se_gate) carries its device
time over Small's 17 SE blocks and what its sums add to launch A. The
stem's row (stem_conv) carries its device time beside the library's
(the weight's cast, cuDNN's channel padding and fprop) at batch 8.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import math
import os
import sys
import threading
import time

import numpy as np
import torch

from rubiksnet_torch.utils import (
    cuda_call_times_ms,
    cuda_kernel_times,
    cuda_queued_time_ms,
)
# The yardstick: the card's peaks and the work of each kernel call, from
# which every bound below is computed, and the library calls the shifts
# are timed beside.
from rubiksnet_torch.utils.roofline import (
    FRAMES,
    HBM_BYTES_PER_S,
    PEAK_F32,
    block_work,
    bound_times_ms,
    channel_last,
    entry_work,
    library_shift,
    shift_grad_work,
    shift_work,
    stem_work,
)

BATCH_CHECK = 2  # clips per kernel / model check
SIZE, CLASSES, MAX_SHIFT = 224, 174, 1
SERVE_BATCHES = (1, 8, 32)
SERVE_ITERS = 10
TIME_BATCH = 8  # clips per kernel timing (bf16)
TRAIN_BATCHES = (8, 16, 32)
TRAIN_WARMUP, TRAIN_ITERS = 2, 5
# The evaluator (rubiksnet_torch.scripts.test_models) on synthetic SSv2-like
# frame folders: (label, two clips, videos a batch, views a video). It
# serves batch x views clips a batch, 32 and 48: K2's and K3's plans at
# those clip counts are checked against plain before it runs.
EVAL_VIDEOS, EVAL_SCALE = 64, 256
EVAL_PROTOCOLS = (("1-clip", False, 32, 1), ("2-clip", True, 8, 6))
EVAL_CLIPS = tuple(sorted({b * v for _, _, b, v in EVAL_PROTOCOLS}))
# Phase 7 (b), (c): frames for resize_crop_u8's check against its plain
# version and for nvjpeg against Pillow, (width, height, what it covers),
# LOADER_COPIES JPEGs of each in one batch: no resize (the evaluator's
# frames), upscales (ksize 3), a portrait frame, and downscales whose
# triangle_coeffs ksize is 5 and 7.
LOADER_FRAMES = ((340, 256, "the evaluator's frames, not resized"),
                 (427, 240, "the raw SSv2 frames, up to 455x256"),
                 (240, 320, "portrait, up to 256x341"),
                 (200, 150, "below the scale, up to 341x256"),
                 (480, 360, "down to 341x256, ksize 5"),
                 (1280, 720, "down to 455x256, ksize 7"))
LOADER_COPIES = 4

# Tolerances (kernel vs its plain version on the same inputs):
# * float32: max |err| / max |ref| <= 1e-4. Both sides compute in f32 and
#   differ only in summation order and in where the separable shift rounds
#   (the kernel sums 8 trilinear corners at once, the plain version shifts
#   one axis at a time).
# * bfloat16: relative L2 <= 1e-2. The kernel rounds once per stored tensor
#   and per GEMM operand; the plain version also rounds each matmul output
#   and each per-axis shift stage to bf16 (8 bits of mantissa, 2^-9 ~ 2e-3
#   per rounding, a few roundings per block).
# * whole model, logits: float32 relative L2 <= 1e-4 (51 blocks of the f32
#   differences above); bfloat16 relative L2 <= 5e-2 (the bf16 roundings of
#   51 residual blocks add up; measured on the tiny tier on the CPU at
#   0.8%).
# * K4 (shift_grad), on its (3, C) float32 result: relative L2 <= 1e-4 for
#   float32 inputs and <= 1e-3 for bfloat16 ones. Both sides take the inputs
#   in f32 and sum in f32 (over up to 1.6M rows at batch 2), in another
#   order; bf16 inputs give larger terms that cancel more.
# * Large f32 train step from one state and batch. The backward alone
#   (the forward through K1 in both runs, so every activation and ReLU mask
#   is bit-identical; raw shift gradients): every parameter's gradient
#   within relative L2 1e-3. The whole step, kernels vs plain shift: loss
#   within 1e-5 relative, BN running statistics within 1e-5 of the largest
#   entry, and every gradient within relative L2 5e-2 (for a shift, over
#   the channels whose raw gradient norm is above 1e-6 of the largest).
#   The last bound is float32's own: a forward that differs in rounding
#   flips the ReLU masks of the few pre-activations within ~1e-7 of zero,
#   and one flip in the 784 samples of a 7x7 channel moves its gradient by
#   ~1e-3. On the CPU the plain route in float32 sits 2e-2 from float64
#   (rel_l2, Large at 112 px), and reordering the plain forward's axes alone
#   moves the gradients by up to 1.7e-2.
TOL_F32_REL_MAX = 1e-4
TOL_BF16_REL_L2 = 1e-2
TOL_MODEL_F32 = 1e-4
TOL_MODEL_BF16 = 5e-2
TOL_SHIFT_GRAD = {"float32": 1e-4, "bfloat16": 1e-3}
TOL_STEP_LOSS, TOL_STEP_GRAD, TOL_STEP_BN = 1e-5, 1e-3, 1e-5
TOL_STEP_GRAD_E2E = 5e-2
SHIFT_CHANNEL_FLOOR = 1e-6

# Large at 224x224: stride-1 (H, C, blocks per forward) and entry
# (H, Cin, Cmid) shapes of the main path.
BLOCK_SHAPES = [(112, 72, 1), (56, 72, 2), (28, 144, 7), (14, 288, 35),
                (7, 576, 2)]
ENTRY_SHAPES = [(112, 72, 72), (56, 72, 144), (28, 144, 288),
                (14, 288, 576)]
# Small (the SE tier, repeats 3/4/6/3) has the same shapes with fewer
# stride-1 blocks; Large-AQ has Large's.
SMALL_BLOCK_SHAPES = [(112, 72, 1), (56, 72, 2), (28, 144, 3), (14, 288, 5),
                      (7, 576, 2)]

# The launch counters of ops.launch_counters(), each launch-count check's
# keys.
LAUNCH_COUNTERS = ("shift3d", "shift3d_inverse", "shift_grad", "fused_block",
                   "fused_block_ring", "fused_entry", "fused_entry_aq",
                   "se_gate", "shift2d", "shift2d_inverse", "bn_relu_train",
                   "bn_relu_train_backward", "stem_conv")


def k2_ring(want):
    """``want`` (launch counts) with K2's launches on two or more operand
    stages: every bfloat16 K2 launch here, so as many as ``fused_block``
    (ops/fused_block.py's rule takes two stages wherever two of 16 rows
    fit beside W, at every shape these checks run)."""
    return dict(want, fused_block_ring=want.get("fused_block", 0))


# Train-mode BN and ReLU sites of a train step (bn1 and bn2 of each block,
# bn_last): Large and Large-AQ, Small; each one forward and one backward
# of the kernel pair outside a data or time group.
BN_SITES, SMALL_BN_SITES = 103, 35
BN_BATCH = 32  # clips of the BN pair's check and timing: the train cell's

# Every kernel of the JSON line: where it lives and what it replaces.
KERNELS = {
    # The 3D shift on its staged route (one device body, three kernels:
    # the forward, the input gradient, the shift gradient).
    "shift3d": ("rubiksnet_torch/ops/csrc/shift3d_bwd.cu",
                "rubiksnet_tpu/ops/pallas/shift_kernel.py:169"),
    "shift3d_inverse": ("rubiksnet_torch/ops/csrc/shift3d_bwd.cu",
                        "rubiksnet_tpu/ops/pallas/shift_kernel.py:169"),
    "shift_grad": ("rubiksnet_torch/ops/csrc/shift3d_bwd.cu",
                   "rubiksnet_tpu/ops/pallas/shift_grad_kernel.py:190"),
    "fused_block": ("rubiksnet_torch/ops/csrc/fused_block.cu",
                    "rubiksnet_tpu/ops/pallas/fused_block.py:455"),
    "fused_entry": ("rubiksnet_torch/ops/csrc/fused_entry_tc.cu",
                    "rubiksnet_tpu/ops/pallas/fused_entry.py:338"),
    # The 2D shift of rubiksnet_tpu/ops/shift2d.py:86-100 and its input
    # gradient :129-146, which reach the TPU kernel on a one-frame view with
    # a zero T row; here kernels of their own (rows staged in shared memory,
    # one channel per thread), rubiks_shift2d_fwd and rubiks_shift2d_inv.
    "shift2d": ("rubiksnet_torch/ops/csrc/shift2d.cu",
                "rubiksnet_tpu/ops/pallas/shift_kernel.py:169"),
    "shift2d_inverse": ("rubiksnet_torch/ops/csrc/shift2d.cu",
                        "rubiksnet_tpu/ops/pallas/shift_kernel.py:169"),
    # K2 with the attention mix (fused_block.py:267 aq_mix), K2 with the SE
    # gate (:215 se_gate, :231 se_conv3_batched; fused_frames.py:459 too) and
    # K3 with it (fused_entry.py:198 gate_from_mean).
    "fused_block_aq": ("rubiksnet_torch/ops/csrc/fused_block.cu",
                       "rubiksnet_tpu/ops/pallas/fused_block.py:455"),
    "fused_block_se": ("rubiksnet_torch/ops/csrc/fused_block.cu",
                       "rubiksnet_tpu/ops/pallas/fused_block.py:455"),
    "fused_entry_se": ("rubiksnet_torch/ops/csrc/fused_entry_tc.cu",
                       "rubiksnet_tpu/ops/pallas/fused_entry.py:338"),
    # K3 with the attention mix: the rubiks3d-aq entries, XLA compositions
    # in the JAX package (rubiksnet_tpu/models/fused_infer.py:144-152 keeps
    # them off the Pallas kernel), on K3's launches here.
    "fused_entry_aq": ("rubiksnet_torch/ops/csrc/fused_entry_tc.cu",
                       "rubiksnet_tpu/models/fused_infer.py:144"),
    # The SE gate of the tensor-core route (fused_block.py:215 se_gate,
    # :231 se_conv3_batched; fused_entry.py:198 gate_from_mean): its sums in
    # launch A (tc_se.cuh), then one launch per SE block.
    "se_gate": ("rubiksnet_torch/ops/csrc/se_gate_tc.cu",
                "rubiksnet_tpu/ops/pallas/fused_block.py:215"),
    # Train-mode BN and its ReLU, forward and backward (three launches
    # each way): no TPU kernel, XLA fuses the JAX package's flax BatchNorm
    # (rubiksnet_tpu/nn/backbone.py:27); here it ran as plain PyTorch ops.
    "bn_relu_train": ("rubiksnet_torch/ops/csrc/bn_relu_train.cu",
                      "none (rubiksnet_tpu/nn/backbone.py:27, XLA)"),
    # The fused executor's stem, the 3x3 stride-2 conv of the frames: no TPU
    # kernel, XLA's nn.Conv in the JAX package; here it ran as cuDNN's
    # channel padding and fprop after a cast of the weight.
    "stem_conv": ("rubiksnet_torch/ops/csrc/stem.cu",
                  "none (rubiksnet_tpu/nn/backbone.py:222, XLA)"),
}


def fail(msg):
    raise RuntimeError(msg)


def child_processes():
    """PIDs of this process's children that have not been waited for,
    running or exited (Linux ``/proc``)."""
    import glob

    pids = []
    for path in glob.glob(f"/proc/{os.getpid()}/task/*/children"):
        with open(path) as f:
            pids += f.read().split()
    return pids


def errors(got, ref):
    got, ref = got.float(), ref.float()
    d = (got - ref)
    max_abs = float(d.abs().max())
    rel_max = max_abs / max(float(ref.abs().max()), 1e-30)
    rel_l2 = float(d.norm()) / max(float(ref.norm()), 1e-30)
    return max_abs, rel_max, rel_l2


def judge(label, got, ref, dtype, results):
    if got.shape != ref.shape:
        fail(f"{label}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got.float()).all():
        fail(f"{label}: non-finite output")
    max_abs, rel_max, rel_l2 = errors(got, ref)
    if dtype == torch.float32:
        ok, what = rel_max <= TOL_F32_REL_MAX, f"rel_max<={TOL_F32_REL_MAX}"
    else:
        ok, what = rel_l2 <= TOL_BF16_REL_L2, f"rel_l2<={TOL_BF16_REL_L2}"
    print(f"  {label}: max_abs={max_abs:.3e} rel_max={rel_max:.3e} "
          f"rel_l2={rel_l2:.3e} [{what}] {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label} outside tolerance")
    results.append(max_abs)


def randomize_bn(model, gen):
    """Non-trivial BN running statistics: mean U(-0.2, 0.2), var U(0.5, 2)."""
    from rubiksnet_torch.nn.backbone import BN

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BN):
                c = mod.running_mean.numel()
                mod.running_mean.copy_(
                    torch.rand(c, generator=gen) * 0.4 - 0.2)
                mod.running_var.copy_(torch.rand(c, generator=gen) * 1.5 + 0.5)
    return model


def random_block(cin, cout, stride, quantize, gen, device,
                 variant="rubiks3d", use_se=False):
    from rubiksnet_torch.nn.backbone import RubiksShiftBlock

    blk = RubiksShiftBlock(cin, cout, stride, quantize, variant, use_se,
                           generator=gen)
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn2):
            c = bn.weight.numel()
            bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
            bn.bias.copy_(torch.rand(c, generator=gen) * 0.6 - 0.3)
    return randomize_bn(blk, gen).to(device).eval()


def randn(shape, dtype, gen, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def rand_shift(c, gen, device, integer_every=0):
    """(3, C) shifts U(-1.8, 1.8); every ``integer_every``-th channel rounded
    to an exact integer (the shift gradient's corrected-tap case)."""
    shift = torch.rand((3, c), generator=gen, device=device) * 3.6 - 1.8
    if integer_every:
        shift[:, ::integer_every] = shift[:, ::integer_every].round()
    return shift


# Shift shapes of Large at 224x224 as (input H, C, stride): the stride-1
# blocks and the mid tensors of the (1, 2, 2) entries.
SHIFT_SHAPES = [(h, c, 1) for h, c, _ in BLOCK_SHAPES] + [
    (h, cm, 2) for h, _, cm in ENTRY_SHAPES]


# The staged route's plan depends on the batch: bands, rows per band and
# units follow N (at 112x112x72 the input gradient's band is 3 rows at
# batch 2 and 11 at batch 8), and with the rows how often a band's ring of
# staged rows wraps. Every staged call after check_shift_staged runs under
# a plan that passed there at its own configuration, or fails the run
# before its kernel launches (BwdPlanGuard).
DDP_LOCAL_BATCH = 4  # phase 11 (a): rows a rank of TIME_BATCH
BWD_BATCHES = sorted({BATCH_CHECK, TIME_BATCH, DDP_LOCAL_BATCH,
                      *TRAIN_BATCHES})
TINY = dict(classes=4, batch=8, size=32, frames=4)  # (a)'s overfit
# Phase 13: the measurement entry points. Serving at TIME_BATCH and at the
# JAX bench's first production batch, training at TIME_BATCH; the shift
# microbench at one stage (name, H, C) at its default batch.
MEASURE_SERVE_BATCHES = (TIME_BATCH, 64)
MICRO_STAGE, MICRO_BATCH = ("stage3", 14, 288), 64
MEASURE_VIDEOS = 8


STAGED_NAMES = {"forward": "K1", "input_grad": "K1-inverse",
                "shift_grad": "K4"}


class BwdPlanGuard:
    """Holds every launch of the staged K1, K1-inverse and K4 to the plans
    that passed their comparison with the plain version. It wraps
    ``ops/shift3d.py::_bwd_prepare``, which the three wrappers call for the
    plan of each launch: while ``recording`` it notes each call's
    configuration and plan (``take`` keeps them once the comparison
    passed); once ``armed``, a configuration and plan not kept fails the
    run. A configuration is checked once, then found in a set (about a
    microsecond of host time a call)."""

    def __init__(self):
        from rubiksnet_torch.ops import shift3d as s3

        self.prepare = s3._bwd_prepare
        # (direction, og, x, stride, padding, dtype, plan)
        self.checked = set()
        self.seen, self.armed, self.passed = [], False, set()
        guard = self

        def prepare(*args):
            got = guard.prepare(*args)
            if args in guard.passed:
                return got
            direction, _, x_shape, stride, padding, dtype, _ = args
            key = (direction, got[4], tuple(x_shape), s3._triple(stride),
                   s3._triple(padding), dtype, got[1])
            if guard.armed:
                if key not in guard.checked:
                    fail(f"{STAGED_NAMES[direction]} at x {tuple(x_shape)} "
                         f"stride {stride} padding {padding} {dtype} would "
                         f"run under {got[1]}, a plan that was not held "
                         f"against the plain version")
                guard.passed.add(args)
            else:
                guard.seen.append(key)
            return got

        prepare.cache_clear = self.prepare.cache_clear
        s3._bwd_prepare = prepare

    def take(self):
        """Keep the plans recorded since the last call."""
        self.checked.update(self.seen)
        self.seen = []


def tiny_shift_calls():
    """(x shape, stride, padding) of every 3D shift of (a)'s tiny model, by
    forward pre-hooks on one train-mode forward on the CPU (plain ops)."""
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet
    from rubiksnet_torch.nn.layers import RubiksShift3D

    model = create_rubiksnet("tiny", TINY["classes"], TINY["frames"],
                             device="cpu",
                             generator=torch.Generator().manual_seed(0))
    model.train()
    calls = set()
    for mod in model.modules():
        if isinstance(mod, RubiksShift3D):
            mod.register_forward_pre_hook(lambda m, a: calls.add(
                (tuple(a[0].shape), m.stride, m.padding)))
    model(torch.zeros((TINY["batch"], TINY["frames"], TINY["size"],
                       TINY["size"], 3)))
    return sorted(calls)


def check_shift_staged(errs, gen, dev):
    """K1, K1-inverse and K4 against their plain versions, f32 and bf16: on
    their staged route (shift3d_bwd.cu) at every Large shift shape at every
    batch that is checked, timed or trained (BWD_BATCHES), at every shift
    of (a)'s tiny model, on one-frame views of Large's shapes, and off the
    model's shapes (shift3d_bwd_probe.CASES: C = 54 and 108, odd extents,
    stride (2, 2, 2) with padding (1, 1, 1), stride (1, 2, 2) with padding
    (0, 1, 0), one clip, shifts of +-9 that take the direct-read route),
    every fourth shift an integer, the forward and the input gradient
    fractional and quantized, every run repeated bit-identically; K1 with a
    bfloat16 shift against its float32 widening; then arms the guard on
    the staged route's plans."""
    from rubiksnet_torch.ops.shift3d import DIRECTIONS, shift3d_kernel
    from rubiksnet_torch.utils import shift3d_bwd_probe as probe

    print(f"[kernels] K1 shift3d, K1-inverse shift3d_inverse and K4 "
          f"shift_grad (staged route, shift3d_bwd.cu) vs plain, Large's "
          f"shapes at batch {BWD_BATCHES}, the tiny model's, CASES; every "
          f"run repeated bit-identically; the plans [K1, K1-inverse, K4] as "
          f"rows per band R, ring rows D, og rows O")
    guard = BwdPlanGuard()
    todo = [(f"{h}x{h}x{c} stride {s}", n, FRAMES, h, h, c, (1, s, s),
             (0, 0, 0), "mixed")
            for n in BWD_BATCHES for h, c, s in SHIFT_SHAPES]
    todo += [(f"{h}x{h}x{c} stride {s} one frame", BATCH_CHECK * FRAMES, 1,
              h, h, c, (1, s, s), (0, 0, 0), "mixed")
             for h, c, s in SHIFT_SHAPES]
    todo += [(f"tiny stride {stride}", *shape, stride, padding, "mixed")
             for shape, stride, padding in tiny_shift_calls()]
    # Phase 13: the shift microbench's stage (stride 1) at its batch.
    _, h, c = MICRO_STAGE
    todo += [(f"{h}x{h}x{c} stride 1 (the shift microbench)", MICRO_BATCH,
              FRAMES, h, h, c, (1, 1, 1), (0, 0, 0), "mixed")]
    # Phase 9 (e): the last entry of Large at ROUTE_SIZE px meets 7 x 7 and
    # runs on the module path, its shift on K1.
    todo += [(f"7x7x576 stride 2 (the last entry at {ROUTE_SIZE} px)",
              BATCH_CHECK, FRAMES, 7, 7, 576, (1, 2, 2), (0, 0, 0), "mixed")]
    for label, n, t, h, w, c, stride, padding, kind in todo + probe.CASES:
        for dt in (torch.float32, torch.bfloat16):
            shift = probe.case_shift(kind, c, gen, dev)
            rows = probe.check_case((n, t, h, w, c), stride, padding, dt,
                                    shift, gen)
            plans = {key[0]: key[-1] for key in guard.seen}
            text = "; ".join(f"{what} {measure}={value:.2e} [<= {bound}]"
                             f"{'' if ok else ' FAIL'}"
                             for what, _, measure, value, bound, ok in rows)
            print(f"  {label} {n}x{t}x{h}x{w}x{c} {str(dt)[6:]}: {text} "
                  f"[" + ", ".join(f"R{plans[d].rows} D{plans[d].ring} "
                                   f"O{plans[d].og_rows}" for d in DIRECTIONS)
                  + "]")
            for what, max_abs, _, _, _, ok in rows:
                if not ok:
                    fail(f"{what} {label} {n}x{t}x{h}x{w}x{c} {dt} outside "
                         f"tolerance or not bit-identical")
                kind_of = ("shift_grad" if what == "shift grad" else
                           "shift3d" if what.startswith("forward") else
                           "shift3d_inverse")
                errs[kind_of].append(max_abs)
            guard.take()
    # A shift parameter cast to bfloat16 (a module cast with .to) widens
    # exactly: K1 gives what it gives for the same values in float32.
    h, c, s = SHIFT_SHAPES[0]
    x = randn((BATCH_CHECK, FRAMES, h, h, c), torch.bfloat16, gen, dev)
    shift = rand_shift(c, gen, dev, integer_every=4).to(torch.bfloat16)
    for q in (False, True):
        same = torch.equal(shift3d_kernel(x, shift, quantize=q),
                           shift3d_kernel(x, shift.float(), quantize=q))
        print(f"  K1 with a bfloat16 shift {h}x{h}x{c} "
              f"{'quantize' if q else 'fractional'}: equal to its float32 "
              f"widening {'ok' if same else 'FAIL'}")
        if not same:
            fail("K1 with a bfloat16 shift differs from the same shift in "
                 "float32")
    guard.take()
    guard.armed = True
    print(f"  {len(guard.checked)} configurations and plans passed; every "
          f"later staged call is held to them")


def overfit_tiny(dev):
    """(a) tests/test_overfit.py's recipe on the card through the kernels:
    tiny, 4 frames, 32 px, a fixed batch of 8 whose brightness encodes the
    label, 40 SGD steps at lr 0.05 (shift multiplier 0.1)."""
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet
    from rubiksnet_torch.ops import launch_counters
    from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult

    classes, batch, size, frames = (TINY[k] for k in ("classes", "batch",
                                                     "size", "frames"))
    model = create_rubiksnet("tiny", classes, frames, device=dev).train()
    step = make_train_step(model, sgd_with_shift_mult(model, 0.05, 0.1))
    gen = torch.Generator(device=dev).manual_seed(0)
    labels = torch.arange(batch, device=dev) % classes
    video = (labels[:, None, None, None, None].float() / classes + 0.1 *
             torch.randn((batch, frames, size, size, 3), generator=gen,
                         device=dev))
    counters = launch_counters()
    before = {k: c.count for k, c in counters.items()}
    losses = []
    for _ in range(40):
        metrics = step(video, labels)
        losses.append(float(metrics["loss"]))
    acc = float(metrics["accuracy"])
    ran = {k: c.count - before[k] for k, c in counters.items()}
    ok = (all(map(math.isfinite, losses)) and losses[-1] < 0.5 * losses[0]
          and acc >= 0.75 and all(ran[k] > 0 for k in (
              "shift3d", "shift3d_inverse", "shift_grad")))
    print(f"  (a) tiny overfit, 40 steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} [< 0.5x], accuracy {acc:.3f} [>= 0.75], "
          f"launches {ran} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("tiny overfit on the card failed")


def large_step_vs_plain(dev, gen):
    """(b) One Large f32 train step through the kernels against the same
    step with the plain shift, from the same state and batch.

    (b1) The whole step, kernels vs ``plain=True``. (b2) The backward alone:
    both runs take the forward through K1, so activations and ReLU masks
    are bit-identical, and one backward runs K1-inverse and K4, the other
    the plain gradients; shift gradients un-normalized.
    """
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet
    from rubiksnet_torch.nn.layers import RubiksShift3D
    from rubiksnet_torch.ops import shift3d
    from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult

    video = torch.randn((BATCH_CHECK, FRAMES, SIZE, SIZE, 3), generator=gen,
                        device=dev)
    labels = torch.randint(0, CLASSES, (BATCH_CHECK,), generator=gen,
                           device=dev)

    def run(plain, normalize=True):
        m = create_rubiksnet("large", CLASSES, FRAMES, "rubiks3d",
                             max_shift=MAX_SHIFT,
                             generator=torch.Generator().manual_seed(0))
        m = randomize_bn(m, torch.Generator().manual_seed(1)).to(dev).train()
        for mod in m.modules():
            if isinstance(mod, RubiksShift3D):
                mod.normalize_grad = normalize
        step = make_train_step(m, sgd_with_shift_mult(m, 0.01), plain=plain)
        loss = float(step(video, labels)["loss"])
        grads = {n: p.grad for n, p in m.named_parameters()}
        stats = {n: b for n, b in m.named_buffers()
                 if not n.endswith("num_batches_tracked")}
        for n, g in grads.items():
            if not torch.isfinite(g).all():
                fail(f"(b) non-finite gradient of {n}")
        return loss, grads, stats

    def worst(got, ref, which, mask=None):
        out = (0.0, "")
        for n, r in ref.items():
            g = got[n]
            if mask is not None and n in mask:
                g, r = g[:, mask[n]], r[:, mask[n]]
            out = max(out, (errors(g, r)[which], n))
        return out

    # (b2): swap the backward kernels for their plain versions; the op
    # looks them up at each backward call.
    loss_k, grad_k, _ = run(False, normalize=False)
    saved = (shift3d.shift3d_input_grad_kernel,
             shift3d.shift3d_shift_grad_kernel)
    shift3d.shift3d_input_grad_kernel = shift3d.shift3d_input_grad_plain
    shift3d.shift3d_shift_grad_kernel = shift3d.shift3d_shift_grad_plain
    try:
        loss_p, grad_p, _ = run(False, normalize=False)
    finally:
        (shift3d.shift3d_input_grad_kernel,
         shift3d.shift3d_shift_grad_kernel) = saved
    g2 = worst(grad_k, grad_p, 2)
    ok = g2[0] <= TOL_STEP_GRAD
    print(f"  (b2) backward only, K1 forward in both: loss bit-identical "
          f"{loss_k == loss_p}; worst gradient rel_l2 {g2[0]:.3e} ({g2[1]}) "
          f"[<= {TOL_STEP_GRAD}] {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("Large f32 backward kernels disagree with the plain backward")
    # Channels whose raw shift gradient is above the floor.
    mask = {n: g.norm(dim=0) > SHIFT_CHANNEL_FLOOR * g.norm(dim=0).max()
            for n, g in grad_p.items() if n.endswith(".shift")}
    del grad_k, grad_p

    loss_k, grad_k, bn_k = run(False)
    loss_p, grad_p, bn_p = run(True)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    g1 = worst(grad_k, grad_p, 2, mask)
    bn = worst(bn_k, bn_p, 1)
    ok = (loss_rel <= TOL_STEP_LOSS and g1[0] <= TOL_STEP_GRAD_E2E
          and bn[0] <= TOL_STEP_BN)
    print(f"  (b1) whole step, kernels vs plain shift, batch {BATCH_CHECK}: "
          f"loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e} "
          f"[<= {TOL_STEP_LOSS}]); worst gradient rel_l2 {g1[0]:.3e} "
          f"({g1[1]}) [<= {TOL_STEP_GRAD_E2E}]; worst BN statistic rel_max "
          f"{bn[0]:.3e} ({bn[1]}) [<= {TOL_STEP_BN}] "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("Large f32 kernel step disagrees with the plain step")


def check_bn_relu(errs, dev):
    """The train-mode BN and ReLU pair against the plain ops
    (``utils/bn_relu_probe.py``: its tolerances and their reasons) at
    every BN shape of a Large train step, bfloat16 at BN_BATCH clips and
    float32 at a quarter of it, and off the model's shapes; output, running
    statistics and count, dx, dweight, dbias, each rerun bit-identical."""
    from rubiksnet_torch.utils import bn_relu_probe as probe

    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"[kernels] bn_relu_train vs plain ops, Large's BN shapes, bf16 "
          f"at batch {BN_BATCH}, f32 at {BN_BATCH // 4}; then off the model")
    cases = [(f"{b}x{FRAMES}x{h}x{h}x{c}", (b, FRAMES, h, h, c), dt, 0)
             for h, c, _ in probe.SITES
             for dt, b in ((torch.bfloat16, BN_BATCH),
                           (torch.float32, BN_BATCH // 4))]
    for label, shape, dt, offset in cases + probe.CASES:
        ok, worst = probe.check_one(label, *probe.inputs(shape, dt, gen, dev,
                                                         offset))
        errs["bn_relu_train"].append(worst)
        if not ok:
            fail(f"bn_relu_train {label} outside tolerance")
        torch.cuda.empty_cache()


def time_bn_relu(timer, dev, name, smi):
    """The pair's six launches at each BN shape of a Large train step at
    BN_BATCH clips, bfloat16: device time by the profiler and by events,
    beside the bound (x and dy read once, the output and dx written once),
    the plain ops and ``F.batch_norm`` with ``F.relu`` (library_ms), summed
    over the step's BN_SITES."""
    from rubiksnet_torch.utils import bn_relu_probe as probe

    print(f"[timing] bn_relu_train, {name} ({smi})")
    t = probe.time_sites(dev, BN_BATCH)
    row = timer.rows["bn_relu_train"]
    row.update(ms=t["events"], device_ms=t["kernels"], plain_ms=t["plain"],
               library_ms=t["library"], bytes_ms=t["bound"],
               bound_ms=t["bound"])


def train_phase(dev, gen, name, smi):
    """Phase 8: the training path. Returns the launch counts of one Large
    bf16 train step at batch 8 (counters zeroed just before it)."""
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet
    from rubiksnet_torch.ops import launch_counters
    from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult

    print("[train] (a) tiny synthetic overfit through the kernels")
    overfit_tiny(dev)
    print("[train] (b) Large f32 train step vs plain shift")
    large_step_vs_plain(dev, gen)
    torch.cuda.empty_cache()

    model = create_rubiksnet("large", CLASSES, FRAMES, "rubiks3d",
                             max_shift=MAX_SHIFT, device=dev,
                             dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0))
    model.train()
    step = make_train_step(model, sgd_with_shift_mult(model, 0.01, 0.1))

    def batch_of(bs):
        video = torch.randn((bs, FRAMES, SIZE, SIZE, 3), generator=gen,
                            device=dev)
        labels = torch.randint(0, CLASSES, (bs,), generator=gen, device=dev)
        return video, labels

    # (c) The main path of this phase: one Large bf16 train step, counted.
    video, labels = batch_of(TIME_BATCH)
    counters = launch_counters()
    for ctr in counters.values():
        ctr.reset()
    metrics = step(video, labels)
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    want = dict(dict.fromkeys(LAUNCH_COUNTERS, 0), shift3d=51,
                shift3d_inverse=51, shift_grad=51, bn_relu_train=BN_SITES,
                bn_relu_train_backward=BN_SITES)
    loss = float(metrics["loss"])
    print(f"[train] (c) launches of one Large bf16 train step, batch "
          f"{TIME_BATCH}: {launches}; loss {loss:.4f}")
    if launches != want:
        fail(f"train step launches {launches} != {want}")
    if not math.isfinite(loss):
        fail("train step loss is not finite")

    # (d) Throughput: CUDA events around each whole step (forward, loss,
    # backward, optimizer).
    print(f"[train] (d) Large bf16 {FRAMES}x{SIZE}x{SIZE} train steps, "
          f"{TRAIN_WARMUP} warm-up + {TRAIN_ITERS} timed, {name} ({smi})")

    def timed_steps(label, fn, bs):
        video, labels = batch_of(bs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = sorted(cuda_call_times_ms(lambda: fn(video, labels),
                                       iters=TRAIN_ITERS,
                                       warmup=TRAIN_WARMUP))
        med = ms[len(ms) // 2]
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  {label} batch {bs}: median {med:.3f} ms/step (min "
              f"{ms[0]:.3f}, max {ms[-1]:.3f}, n={len(ms)}), "
              f"{bs * 1000.0 / med:.1f} clips/s, peak memory {peak:.2f} GiB "
              f"({name}, {smi})")

    for bs in TRAIN_BATCHES:
        timed_steps("kernels", step, bs)
    plain_step = make_train_step(model, step.optimizer, plain=True)
    timed_steps("plain shift", plain_step, TIME_BATCH)
    return launches


def rand_shift2d(c, gen, device):
    """(2, C) shifts U(-1.8, 1.8); every fourth channel a multiple of 0.5,
    so quantize meets exact ties of both signs and integers."""
    shift = torch.rand((2, c), generator=gen, device=device) * 3.6 - 1.8
    shift[:, ::4] = (shift[:, ::4] * 2).round() / 2
    return shift


# The 2D shift kernels off the model's shapes, as (label, frames, H, W, C,
# stride, padding, shift kind): widths that are not a multiple of the
# 16-byte vector (the tiny tier's 54 and 108), odd extents, one frame,
# shifts of +-9 (more source rows than the ring holds: the direct route),
# a tensor whose first channel group takes the direct route and the others
# the staged one, and negative coordinates (padding) with every shift a
# multiple of 0.5 (exact ties of both signs under quantize).
SHIFT2D_CASES = [
    ("C=54", 16, 28, 28, 54, 1, 0, "mixed"),
    ("C=54 stride 2", 16, 28, 28, 54, 2, 0, "mixed"),
    ("C=108", 16, 14, 14, 108, 1, 0, "mixed"),
    ("C=108 stride 2", 16, 14, 14, 108, 2, 1, "mixed"),
    ("7x9", 16, 7, 9, 72, 1, 0, "mixed"),
    ("7x9 stride 2", 16, 7, 9, 72, 2, 0, "mixed"),
    ("113x57", 3, 113, 57, 72, 1, 0, "mixed"),
    ("113x57 stride 2", 3, 113, 57, 72, 2, (1, 2), "mixed"),
    ("one frame", 1, 28, 28, 144, 1, 0, "mixed"),
    ("one frame stride 2", 1, 28, 28, 144, 2, 0, "mixed"),
    ("shifts of +-9", 16, 28, 28, 144, 1, 0, "far"),
    ("shifts of +-9 stride 2", 16, 56, 56, 144, 2, 0, "far"),
    ("both routes", 16, 14, 14, 288, 1, 0, "far-first-group"),
    ("both routes stride 2", 16, 28, 28, 288, 2, 0, "far-first-group"),
    ("ties, negative coordinates", 16, 14, 14, 288, 1, (2, 1), "halves"),
    ("ties, negative coordinates, stride 2", 16, 28, 28, 288, 2, (2, 1),
     "halves"),
]


def shift2d_case_shift(kind, c, gen, device):
    shift = rand_shift2d(c, gen, device)
    far = 9.0 * (1 - 2 * (torch.arange(c, device=device) % 2))
    if kind == "far":
        shift = shift / 2 + far
    elif kind == "far-first-group":
        shift[:, :8] = shift[:, :8] / 2 + far[:8]
    elif kind == "halves":
        shift = (torch.rand((2, c), generator=gen, device=device) * 10
                 - 5).round() / 2
    return shift


def check_shift2d_cases(errs, gen, dev):
    """SHIFT2D_CASES, forward and input gradient, f32 and bf16, fractional
    and quantized, against the plain versions; each kernel twice on the
    same inputs, bit-identical."""
    from rubiksnet_torch.ops import shift2d

    print("[kernels] shift2d / shift2d_inverse off the model's shapes; "
          "every run repeated bit-identically")
    for label, n, h, w, c, s, pad, kind in SHIFT2D_CASES:
        for dt in (torch.float32, torch.bfloat16):
            x = randn((n, h, w, c), dt, gen, dev)
            shift = shift2d_case_shift(kind, c, gen, dev)
            for q in (False, True):
                tag = (f"{label} {n}x{h}x{w}x{c} {str(dt)[6:]} "
                       f"{'quantize' if q else 'fractional'}")
                got = shift2d.shift2d_kernel(x, shift, s, pad, q)
                again = shift2d.shift2d_kernel(x, shift, s, pad, q)
                ref = shift2d.shift2d_plain(x, shift, s, pad, q)
                judge(f"shift2d {tag}", got, ref, dt, errs["shift2d"])
                og = randn(got.shape, dt, gen, dev)
                got_i = shift2d.shift2d_input_grad_kernel(og, shift, x.shape,
                                                          s, pad, q)
                again_i = shift2d.shift2d_input_grad_kernel(
                    og, shift, x.shape, s, pad, q)
                ref_i = shift2d.shift2d_input_grad_plain(og, shift, x.shape,
                                                         s, pad, q)
                judge(f"shift2d_inverse {tag}", got_i, ref_i, dt,
                      errs["shift2d_inverse"])
                if not (torch.equal(got, again)
                        and torch.equal(got_i, again_i)):
                    fail(f"{tag}: two runs on the same inputs differ")
                if q and not (torch.equal(got, ref)
                              and torch.equal(got_i, ref_i)):
                    fail(f"{tag}: a quantized shift is a copy and must "
                         f"equal the plain version exactly")


# The stem (ops/stem.py, csrc/stem.cu) against its plain version: (label,
# clips, H, W, C) of FRAMES frames a clip: 224 px at the serving batches
# and the benchmark's, 112 px, odd sizes (2- and 4-byte line copies) and
# Tiny's width 54.
STEM_CASES = (("224 px", 1, SIZE, SIZE, 72), ("224 px", 8, SIZE, SIZE, 72),
              ("224 px", 64, SIZE, SIZE, 72), ("112 px", 8, 112, 112, 72),
              ("odd", 2, 33, 45, 72), ("odd, 4-byte lines", 2, 56, 42, 72),
              ("Tiny's width", 2, SIZE, SIZE, 54),
              ("Tiny's width, odd", 2, 45, 33, 54))


def check_stem(errs, gen, dev):
    """The stem's kernel against its plain version (cuDNN, TF32 off) at
    STEM_CASES, f32 and bf16, each run twice and bit-identical."""
    from rubiksnet_torch.ops import stem

    print("[kernels] stem_conv (stem.cu) vs plain (F.conv2d on the unpacked "
          "weight)")
    for label, b, h, w, c in STEM_CASES:
        weight = torch.randn((c, 3, 3, 3), generator=gen, device=dev) * 0.3
        for dt in (torch.float32, torch.bfloat16):
            x = randn((b, FRAMES, h, w, 3), dt, gen, dev)
            packed = stem.pack_stem_weight(weight, dt)
            got = stem.stem_conv_kernel(x, packed)
            again = stem.stem_conv_kernel(x, packed)
            tag = f"stem {label} {b}x{FRAMES}x{h}x{w}->{c} {str(dt)[6:]}"
            judge(tag, got, stem.stem_conv_plain(x, packed), dt,
                  errs["stem_conv"])
            if not torch.equal(got, again):
                fail(f"{tag}: a second run differs")
            del x, got, again
    torch.cuda.empty_cache()


def check_new_kernels(errs, gen, cpu_gen, dev):
    """The 2D shift's forward and input-gradient kernels, K2 with the
    attention mix, with the SE gate and with both, K3 with the SE gate and
    K3 with the attention mix (K3-AQ, at batch TIME_BATCH), against their
    plain versions at the Large-AQ and Small shapes, f32 and bf16. Every SE
    and K3-AQ run is repeated and must agree bit for bit."""
    from rubiksnet_torch.ops import shift2d
    from rubiksnet_torch.ops.fused_block import (
        fold_blocks,
        fused_block_kernel,
        fused_block_plain,
        stack_se_params,
    )
    from rubiksnet_torch.ops.fused_entry import (
        fused_entry_kernel,
        fused_entry_plain,
        stack_entry_params,
        stack_entry_params_aq,
    )

    dtypes = (torch.float32, torch.bfloat16)
    print("[kernels] shift2d / shift2d_inverse (shift2d.cu) vs the 2D gather "
          "forms (quantize: half away from zero)")
    for h, c, s in SHIFT_SHAPES:
        for dt in dtypes:
            x = randn((BATCH_CHECK * FRAMES, h, h, c), dt, gen, dev)
            shift = rand_shift2d(c, gen, dev)
            for q in (False, True):
                mode = "quantize" if q else "fractional"
                got = shift2d.shift2d_kernel(x, shift, s, 0, q)
                ref = shift2d.shift2d_plain(x, shift, s, 0, q)
                judge(f"shift2d {h}x{h}x{c} stride {s} {str(dt)[6:]} {mode}",
                      got, ref, dt, errs["shift2d"])
                og = randn(got.shape, dt, gen, dev)
                got = shift2d.shift2d_input_grad_kernel(og, shift, x.shape,
                                                        s, 0, q)
                ref = shift2d.shift2d_input_grad_plain(og, shift, x.shape, s,
                                                       0, q)
                judge(f"shift2d_inverse {h}x{h}x{c} stride {s} "
                      f"{str(dt)[6:]} {mode}", got, ref, dt,
                      errs["shift2d_inverse"])
    check_shift2d_cases(errs, gen, dev)

    def twice(label, fn):
        got, again = fn(), fn()
        if not torch.equal(got, again):
            fail(f"{label}: two runs on the same inputs differ")
        return got

    print("[kernels] K2 fused_block (2 blocks) with the attention mix (AQ), "
          "the SE gate, and both, vs plain; SE runs bit-identical on a "
          "rerun")
    for h, c, _ in BLOCK_SHAPES:
        for dt in dtypes:
            for aq, se in ((True, False), (False, True), (True, True)):
                variant = "rubiks3d-aq" if aq else "rubiks3d"
                blocks = [random_block(c, c, 1, False, cpu_gen, dev, variant,
                                       se) for _ in range(2)]
                vt, wm, sep = fold_blocks(blocks, dt, MAX_SHIFT, aq=aq,
                                          se=se)
                x = randn((BATCH_CHECK, FRAMES, h, h, c), dt, gen, dev)
                label = (f"K2{'-AQ' if aq else ''}{'-SE' if se else ''} "
                         f"{h}x{h}x{c} {str(dt)[6:]}")
                got = twice(label, lambda: fused_block_kernel(
                    x, vt, wm, sep, aq=aq, max_shift=MAX_SHIFT))
                ref = fused_block_plain(x, vt, wm, sep, aq=aq,
                                        max_shift=MAX_SHIFT)
                result = []
                judge(label, got, ref, dt, result)
                for k in block_kinds(aq, se):
                    errs[k].extend(result)

    print("[kernels] K3 fused_entry with the SE gate vs plain; bit-identical "
          "on a rerun")
    for h, cin, cm in ENTRY_SHAPES:
        for dt in dtypes:
            for q in (False, True):
                blk = random_block(cin, cm, 2, q, cpu_gen, dev, use_se=True)
                params = stack_entry_params(blk, dt, MAX_SHIFT, q)
                sep = stack_se_params([blk])[0]
                x = randn((BATCH_CHECK, FRAMES, h, h, cin), dt, gen, dev)
                label = (f"K3-SE {h}x{h}x{cin}->{cm} {str(dt)[6:]} "
                         f"{'quantize' if q else 'fractional'}")
                got = twice(label, lambda: fused_entry_kernel(
                    x, params, sep, max_shift=MAX_SHIFT))
                ref = fused_entry_plain(x, params, sep, max_shift=MAX_SHIFT)
                judge(label, got, ref, dt, errs["fused_entry_se"])

    print(f"[kernels] K3-AQ fused_entry with the attention mix (Large-AQ's "
          f"entries) vs plain, batch {TIME_BATCH}; bit-identical on a rerun")
    for h, cin, cm in ENTRY_SHAPES:
        blk = random_block(cin, cm, 2, False, cpu_gen, dev, "rubiks3d-aq")
        for dt in dtypes:
            params = stack_entry_params_aq(blk, dt, MAX_SHIFT)
            x = randn((TIME_BATCH, FRAMES, h, h, cin), dt, gen, dev)
            label = f"K3-AQ {h}x{h}x{cin}->{cm} {str(dt)[6:]}"
            got = twice(label, lambda: fused_entry_kernel(
                x, params, aq=True, max_shift=MAX_SHIFT))
            ref = fused_entry_plain(x, params, aq=True, max_shift=MAX_SHIFT)
            judge(label, got, ref, dt, errs["fused_entry_aq"])


def block_kinds(aq, se):
    """The rows of the kernels line a K2 comparison belongs to."""
    return [kd for kd, on in (("fused_block_aq", aq),
                              ("fused_block_se", se)) if on] or ["fused_block"]


# K2's launch plan depends on the batch (rows per tile, warps, column
# chunks, row tiles per block, producer warps). Every plan that is timed or
# served below is first held against the plain version at its own shape:
# (shape, aq, se) -> the plan of the comparison that passed.
CHECKED_PLANS = {}


def check_block_served_shapes(errs, gen, cpu_gen, dev):
    """K2 in bf16 at every stride-1 shape of the main path (Large's and
    Small's) at every batch size that is timed or served (SERVE_BATCHES,
    TIME_BATCH and the evaluator's EVAL_CLIPS), rubiks3d, aq, se and
    aq+se, a run of 2 blocks, twice
    bit-identically, against the plain version, with se also the gate alone
    against the plain gate of the kernel's mid (its error to the se_gate
    row)."""
    from rubiksnet_torch.utils import fused_block_probe as probe

    bf = torch.bfloat16
    batches = sorted(set(SERVE_BATCHES) | {TIME_BATCH} | set(EVAL_CLIPS))
    print(f"[kernels] K2 fused_block bf16 at the main path's shapes, batch "
          f"{batches}: the plans that are timed and served, vs plain; every "
          f"run repeated bit-identically")
    for label, n, t, h, w, c, k, kind, blocks in probe.served_cases(batches):
        for aq, se in probe.VARIANTS:
            ok, max_abs, text, plan = probe.check_case(
                label, (n, t, h, w, c), k, kind, blocks, aq, se, bf, gen,
                cpu_gen, dev, gate_errs=errs["se_gate"])
            print("  " + text)
            if not ok:
                fail(f"K2 {label} aq={aq} se={se} bf16 failed")
            CHECKED_PLANS[(n, t, h, w, c), aq, se] = plan
            for kd in block_kinds(aq, se):
                errs[kd].append(max_abs)


def checked_plan(shape, aq, se, dev):
    """The plan a bf16 call at ``shape`` runs under; fails unless that very
    plan passed its comparison with the plain version at this shape."""
    from rubiksnet_torch.ops.fused_block import (
        _sm_count,
        fused_block_plan,
        kernel_taps,
    )

    # With the gate the plan depends on its tap window (MAX_SHIFT here).
    plan = fused_block_plan(
        shape, torch.bfloat16, sms=_sm_count(dev.index),
        gate=(kernel_taps(MAX_SHIFT), MAX_SHIFT) if se else None)
    if CHECKED_PLANS.get((tuple(shape), aq, se)) != plan:
        fail(f"K2 at {tuple(shape)} aq={aq} se={se} would be timed under a "
             f"plan that was not held against the plain version: "
             f"{plan.describe()}")
    return plan


# K3's plan depends on the batch as K2's does: (shape, Cm, se, aq) -> the
# plan of the bf16 comparison that passed there.
CHECKED_ENTRY_PLANS = {}
# K3's forms: (se, aq).
ENTRY_FORMS = ((False, False), (True, False), (False, True))


def entry_kind(se, aq):
    """The row of the kernels line a K3 comparison belongs to."""
    return "fused_entry_se" if se else "fused_entry_aq" if aq else (
        "fused_entry")


def check_entry_served_shapes(errs, gen, cpu_gen, dev):
    """K3, K3-SE and K3-AQ in bf16 on the tensor-core route at every entry
    shape of the main path (Large's, Small's and Large-AQ's) at every batch
    size that is timed or served (the evaluator's EVAL_CLIPS included),
    twice bit-identically, against the plain version, K3-SE's gate
    also alone (as K2's)."""
    from rubiksnet_torch.utils import fused_entry_probe as probe

    bf = torch.bfloat16
    batches = sorted(set(SERVE_BATCHES) | {TIME_BATCH} | set(EVAL_CLIPS))
    print(f"[kernels] K3 fused_entry bf16 at the main path's shapes, batch "
          f"{batches}: the plans that are timed and served, vs plain; every "
          f"run repeated bit-identically")
    for label, n, t, h, w, cin, cm, k, kind in probe.served_cases(batches):
        for se, aq in ENTRY_FORMS:
            ok, max_abs, text, plan = probe.check_case(
                label, (n, t, h, w, cin), cm, k, kind, se, bf, gen, cpu_gen,
                dev, gate_errs=errs["se_gate"], aq=aq)
            print("  " + text)
            if not ok:
                fail(f"K3 {label} se={se} aq={aq} bf16 failed")
            CHECKED_ENTRY_PLANS[(n, t, h, w, cin), cm, se, aq] = plan
            errs[entry_kind(se, aq)].append(max_abs)


def checked_entry_plan(shape, cm, se, dev, aq=False):
    """The plan a bf16 K3 call at ``shape`` runs under; fails unless that
    very plan passed its comparison with the plain version at this shape,
    in this form."""
    from rubiksnet_torch.ops.fused_block import _sm_count
    from rubiksnet_torch.ops.fused_entry import fused_entry_plan

    plan = fused_entry_plan(shape, cm, torch.bfloat16,
                            sms=_sm_count(dev.index))
    if CHECKED_ENTRY_PLANS.get((tuple(shape), cm, se, aq)) != plan:
        fail(f"K3 at {tuple(shape)}->{cm} se={se} aq={aq} would be timed "
             f"under a plan that was not held against the plain version: "
             f"{plan.describe()}")
    return plan


def check_entry_cases(errs, gen, cpu_gen, dev):
    """K3 and K3-SE off the model's shapes
    (rubiksnet_torch.utils.fused_entry_probe CASES: Cin 54 -> 108,
    max_shift 3 with shifts near +-3, quantized, integer and zero shifts,
    one clip, non-square even H x W, taps with three weights per axis), f32
    and bf16, each run twice bit-identically; then the device kernels of a
    bf16 and an f32 call, by name."""
    from rubiksnet_torch.utils import fused_entry_probe as probe

    print("[kernels] K3 fused_entry off the model's shapes, vs plain; every "
          "run repeated bit-identically; the plan in brackets")
    for label, n, t, h, w, cin, cm, k, kind in probe.CASES:
        for dt in (torch.float32, torch.bfloat16):
            for se in (False, True):
                ok, max_abs, text, _ = probe.check_case(
                    label, (n, t, h, w, cin), cm, k, kind, se, dt, gen,
                    cpu_gen, dev, gate_errs=(errs["se_gate"]
                                             if dt == torch.bfloat16
                                             else None))
                print("  " + text)
                if not ok:
                    fail(f"K3 {label} se={se} {dt} failed")
                errs["fused_entry_se" if se else "fused_entry"].append(
                    max_abs)
    ok, text = probe.route_kernels(gen, cpu_gen, dev)
    print(f"[launch] {text}")
    if not ok:
        fail("K3: bf16 must run rubiks_entry_tc_kernel and f32 gemm_kernel, "
             "neither the other's")


def check_block_cases(errs, gen, cpu_gen, dev):
    """K2 off the model's shapes (rubiksnet_torch.utils.fused_block_probe
    CASES: widths 54, 108, 216 and 432, one clip, odd extents, max_shift 3
    with shifts near +-3 and max_shift 7, quantized, integer and zero
    shifts, taps with three weights per axis, a run of 3 blocks through the
    one C call), rubiks3d, aq, se and aq+se, f32 and bf16, each run twice
    bit-identically; then the device kernels of one bf16 and one f32 call,
    by name: bf16 must run the tensor-core kernels and f32 the SIMT GEMM,
    neither the other's."""
    from rubiksnet_torch.ops.fused_block import fused_block_kernel
    from rubiksnet_torch.utils import fused_block_probe as probe

    print("[kernels] K2 fused_block off the model's shapes, vs plain; every "
          "run repeated bit-identically; the plan's route in brackets")
    for label, n, t, h, w, c, k, kind, blocks in probe.CASES:
        for dt in (torch.float32, torch.bfloat16):
            for aq, se in probe.case_variants(kind):
                ok, max_abs, text, _ = probe.check_case(
                    label, (n, t, h, w, c), k, kind, blocks, aq, se, dt, gen,
                    cpu_gen, dev, gate_errs=(errs["se_gate"]
                                             if dt == torch.bfloat16
                                             else None))
                print("  " + text)
                if not ok:
                    fail(f"K2 {label} aq={aq} se={se} {dt} failed")
                for kd in block_kinds(aq, se):
                    errs[kd].append(max_abs)

    for dt, want, never in ((torch.bfloat16, "rubiks_tc_kernel",
                             "gemm_kernel"),
                            (torch.float32, "gemm_kernel",
                             "rubiks_tc_kernel")):
        vt, wm, sep = probe.make_run(288, 2, True, True, dt, 1, "frac",
                                     cpu_gen, dev)
        x = randn((BATCH_CHECK, FRAMES, 14, 14, 288), dt, gen, dev)
        times = cuda_kernel_times(lambda: fused_block_kernel(
            x, vt, wm, sep, aq=True, max_shift=1), iters=3)
        names = sorted(times)
        print(f"[launch] K2-AQ-SE 14x14x288 {str(dt)[6:]}, 2 blocks in one "
              f"call, device kernels by the profiler: "
              + "; ".join(f"{nm[:70]} x{times[nm][0] / 3:g}"
                          for nm in names))
        if not any(want in nm for nm in names) or any(
                never in nm for nm in names):
            fail(f"K2 {dt}: expected {want} kernels and no {never}, got "
                 f"{names}")


PROFILER_MISSES = []  # labels whose device time is not the profiler's


def profiled_ms(fn, needle, label, iters=5, expect=None):
    """(device ms per call of the kernels whose name holds ``needle``, device
    kernels of any name per call) of ``fn()``, by torch.profiler. The
    profiler now and then hands back a window with some or all of its
    device records missing, never with more: a window with more than
    ``expect`` kernels per call (where it is given) fails the run at once; a
    window with fewer, or with records that are not a whole number per
    call, is taken again, at most three times, and every window's count is
    printed. After three such windows the time is taken by CUDA events with
    the calls queued behind a spinning kernel, the count is unknown (None),
    and the label is kept for the report."""
    why, seen = "", []
    for _ in range(3):
        try:
            times = cuda_kernel_times(fn, iters=iters)
        except RuntimeError as err:
            why = str(err)
            seen.append("none")
            continue
        records = sum(n for n, _ in times.values())
        per_call = records / iters
        seen.append(f"{per_call:g}")
        if expect is not None and records > expect * iters:
            fail(f"{label}: the profiler saw {per_call:g} device kernels per "
                 f"call, more than the {expect} of one call")
        if (per_call >= 1 and abs(per_call - round(per_call)) < 1e-6
                and expect in (None, round(per_call))):
            if len(seen) > 1:
                print(f"  {label}: kernels per call by profiler window: "
                      f"{', '.join(seen)}")
            total = sum(ms for k, (_, ms) in times.items() if needle in k)
            return total / iters, round(per_call)
        why = (f"the profiler kept {records:g} kernel records of {iters} "
               f"calls")
    print(f"  {label}: {why} (kernels per call by window: {', '.join(seen)});"
          f" device time by events behind a blocking kernel instead")
    PROFILER_MISSES.append(label)
    return cuda_queued_time_ms(fn), None


class Timer:
    """Sums, per kernel name, the time of its calls over one forward or
    train step beside the plain version's, the library call's and the
    bound."""

    def __init__(self, names):
        self.rows = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                         "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0,
                         "device_ms": None, "library_device_ms": None}
                     for k in names}

    def add(self, kind, label, count, kernel_fn, plain_fn, work, dtype,
            lib_fn=None, kernels_per_call=1, note="", device=False,
            lib_label="depthwise conv"):
        """``device``: also the device time of ``kernel_fn`` by the
        profiler (every device kernel of a call), which must launch exactly
        ``kernels_per_call`` device kernels per call, and that of
        ``lib_fn``."""
        from rubiksnet_torch.utils import cuda_time_ms

        row = self.rows[kind]
        ms, plain_ms = cuda_time_ms(kernel_fn), cuda_time_ms(plain_fn)
        tb, to = bound_times_ms(work, dtype)
        row["ms"] += count * ms
        row["plain_ms"] += count * plain_ms
        row["bytes_ms"] += count * tb
        row["ops_ms"] += count * to
        row["bound_ms"] += count * max(tb, to)
        text = (f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {max(tb, to):.4f} ms "
                f"({'bytes' if tb >= to else 'operations'})")
        if lib_fn is not None:
            # The library call must compute the same function.
            _, _, rel = errors(channel_last(lib_fn()), kernel_fn())
            if rel > 2 * TOL_BF16_REL_L2:
                fail(f"{label}: the library call disagrees, rel_l2 {rel}")
            lib_ms = cuda_time_ms(lib_fn, iters=5)
            row["library_ms"] = (row["library_ms"] or 0.0) + count * lib_ms
            text += f", library ({lib_label}) {lib_ms:.4f} ms"
        if device:
            dev_ms, n_kernels = profiled_ms(kernel_fn, "", label,
                                            expect=kernels_per_call)
            if n_kernels not in (kernels_per_call, None):
                fail(f"{label}: one call launched {n_kernels} device "
                     f"kernels, not {kernels_per_call}")
            timed = [("device_ms", dev_ms)]
            text += (f"; on the device {dev_ms:.4f} ms, {n_kernels} kernels "
                     f"per call by the profiler")
            if lib_fn is not None:
                lib_dev_ms, lib_n = profiled_ms(lib_fn, "",
                                                f"{label}, library")
                timed.append(("library_device_ms", lib_dev_ms))
                text += (f"; library on the device {lib_dev_ms:.4f} ms in "
                         f"{lib_n} kernels per call")
            for key, v in timed:
                row[key] = (row[key] or 0.0) + count * v
        text += note
        print(f"{text} (x{count} per forward or train step)")

    def summary(self, kind, per):
        row = self.rows[kind]
        by = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.3f} ms")
        text = (f"  {kind}: {row['ms']:.3f} ms per {per}, plain "
                f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
                f"({by}), library {lib}")
        if row["device_ms"] is not None:
            text += f", device_ms {row['device_ms']:.3f}"
        if row["library_device_ms"] is not None:
            text += (f", library on the device "
                     f"{row['library_device_ms']:.3f} ms")
        print(text)


def time_block_runs(timer, gen, cpu_gen, dev, small_counts):
    """K2 as the models call it: per stage one run of all its blocks in one C
    call, by events; consecutive launches overlapped (programmatic dependent
    launch, the plan's default) and not overlapped (the same plan without
    the launch attribute), in turn; the plan must have passed its
    comparison at this shape. The overlapped sum goes to the row as
    ``runs_ms``."""
    from rubiksnet_torch.ops.fused_block import fused_block_kernel
    from rubiksnet_torch.utils import cuda_time_ms
    from rubiksnet_torch.utils import fused_block_probe as probe

    bf, k = torch.bfloat16, MAX_SHIFT
    print(f"[timing] K2 per stage, one run of the stage's blocks in one call, "
          f"batch {TIME_BATCH} bf16, by events")
    for kind, tag, aq, se in (("fused_block", "K2", False, False),
                              ("fused_block_aq", "K2-AQ", True, False),
                              ("fused_block_se", "K2-SE", False, True)):
        sums = {"overlapped": 0.0, "not overlapped": 0.0}
        for h, c, count in BLOCK_SHAPES:
            blocks = small_counts[h] if se else count
            vt, wm, sep = probe.make_run(c, blocks, aq, se, bf, k, "frac",
                                         cpu_gen, dev)
            x = randn((TIME_BATCH, FRAMES, h, h, c), bf, gen, dev)
            plan = checked_plan(x.shape, aq, se, dev)
            text = f"  {tag} {h}x{h}x{c} run of {blocks}:"
            for label, kw in (("overlapped", {}),
                              ("not overlapped", {"overlap": False})):
                ms = cuda_time_ms(lambda: fused_block_kernel(
                    x, vt, wm, sep, aq=aq, max_shift=k, **kw), iters=10)
                sums[label] += ms
                text += f" {label} {ms:.4f} ms,"
            print(f"{text} plan: {plan.describe()}")
        timer.rows[kind]["runs_ms"] = sums["overlapped"]
        print(f"  {tag} per forward, as runs: " + ", ".join(
            f"{label} {ms:.3f} ms" for label, ms in sums.items()))


def entry_parts(fn):
    """Device ms per call of K3's launch A, launch B and the SE gate's two
    launches, by torch.profiler's kernel names."""
    from rubiksnet_torch.utils.fused_entry_probe import launch_of

    times = cuda_kernel_times(fn, iters=5)
    parts = {}
    for nm, (_, ms) in times.items():
        part = launch_of(nm) or "other"
        parts[part] = parts.get(part, 0.0) + ms / 5
    return "device by launch " + ", ".join(
        f"{part} {ms:.4f} ms" for part, ms in sorted(parts.items()))


def time_stem(timer, gen, dev):
    """The stem at batch TIME_BATCH, 224 px, bf16, beside the library call
    it replaced (the weight's cast, cuDNN's channel padding and fprop), by
    events and by the profiler: one device kernel a call."""
    import torch.nn.functional as F

    from rubiksnet_torch.ops import stem

    c, n = 72, TIME_BATCH * FRAMES
    weight = torch.randn((c, 3, 3, 3), generator=gen, device=dev) * 0.3
    x = randn((TIME_BATCH, FRAMES, SIZE, SIZE, 3), torch.bfloat16, gen, dev)
    packed = stem.pack_stem_weight(weight, torch.bfloat16)
    flat = x.reshape(n, SIZE, SIZE, 3).permute(0, 3, 1, 2)
    timer.add("stem_conv", f"stem {SIZE}x{SIZE}x3->{c}", 1,
              lambda: stem.stem_conv_kernel(x, packed).flatten(0, 1),
              lambda: stem.stem_conv_plain(x, packed).flatten(0, 1),
              stem_work(n, SIZE, SIZE, c, 2), torch.bfloat16,
              lambda: F.conv2d(flat, weight.to(torch.bfloat16), stride=2,
                               padding=1), device=True,
              lib_label="cuDNN: the weight's cast, padding, fprop")


def time_kernels(timer, gen, cpu_gen, dev, name, smi):
    """Kernel times at batch TIME_BATCH, bf16, summed over one forward's or
    one train step's calls at each shape (calls per shape from the model's
    plan)."""
    from rubiksnet_torch.ops import shift2d
    from rubiksnet_torch.ops.fused_block import (
        fold_blocks,
        fused_block_kernel,
        fused_block_plain,
        stack_se_params,
    )
    from rubiksnet_torch.ops.fused_entry import (
        fused_entry_kernel,
        fused_entry_plain,
        stack_entry_params,
        stack_entry_params_aq,
    )
    from rubiksnet_torch.ops.shift3d import (
        compute_output_shape_3d,
        shift3d_input_grad_kernel,
        shift3d_input_grad_plain,
        shift3d_kernel,
        shift3d_plain,
        shift3d_shift_grad_kernel,
        shift3d_shift_grad_plain,
    )
    from rubiksnet_torch.utils import cuda_time_ms

    print(f"[timing] per call, batch {TIME_BATCH} bf16, {name} ({smi})")
    bf, nb, k = torch.bfloat16, TIME_BATCH, MAX_SHIFT
    rows3, rows_aq = 4 + 3 * 3, 4 + 3 * 3 + 3
    small_counts = {h: n for h, _, n in SMALL_BLOCK_SHAPES}

    for h, c, count in BLOCK_SHAPES:
        x = randn((nb, FRAMES, h, h, c), bf, gen, dev)
        shift = torch.rand((3, c), generator=gen, device=dev) * 2 - 1
        # One call of the staged K1 is one device kernel.
        timer.add("shift3d", f"K1 {h}x{h}x{c} stride 1", count,
                  lambda: shift3d_kernel(x, shift),
                  lambda: shift3d_plain(x, shift),
                  shift_work(x.numel(), x.numel(), 2, 8), bf,
                  library_shift(x, shift, 1), device=True)
        blocks = {}
        for aq, se in ((False, False), (True, False), (False, True)):
            blk = random_block(c, c, 1, False, cpu_gen, dev,
                               "rubiks3d-aq" if aq else "rubiks3d", se)
            blocks[aq, se] = fold_blocks([blk], bf, k, aq=aq, se=se)

        def run(fn, aq, se):
            vt, wm, sep = blocks[aq, se]
            return lambda: fn(x, vt, wm, sep, aq=aq, max_shift=k)

        for kind, tag, aq, se, n_calls in (
                ("fused_block", "K2", False, False, count),
                ("fused_block_aq", "K2-AQ", True, False, count),
                ("fused_block_se", "K2-SE", False, True, small_counts[h])):
            plan = checked_plan(x.shape, aq, se, dev)
            timer.add(kind, f"{tag} {h}x{h}x{c} 1 block", n_calls,
                      run(fused_block_kernel, aq, se),
                      run(fused_block_plain, aq, se),
                      block_work(nb, h, c, 2, rows_aq if aq else rows3, aq,
                                 se), bf,
                      kernels_per_call=3 if se else 2,
                      note=f"; plan: {plan.describe()}", device=True)
    time_block_runs(timer, gen, cpu_gen, dev, small_counts)
    for h, cin, cm in ENTRY_SHAPES:
        xm = randn((nb, FRAMES, h, h, cm), bf, gen, dev)
        shift = torch.rand((3, cm), generator=gen, device=dev) * 2 - 1
        timer.add("shift3d", f"K1 {h}x{h}x{cm} stride 2", 1,
                  lambda: shift3d_kernel(xm, shift, (1, 2, 2)),
                  lambda: shift3d_plain(xm, shift, (1, 2, 2)),
                  shift_work(xm.numel() // 4, xm.numel(), 2, 8), bf,
                  library_shift(xm, shift, 2), device=True)
        x = randn((nb, FRAMES, h, h, cin), bf, gen, dev)
        for kind, tag, se in (("fused_entry", "K3", False),
                              ("fused_entry_se", "K3-SE", True)):
            blk = random_block(cin, cm, 2, False, cpu_gen, dev, use_se=se)
            params = stack_entry_params(blk, bf, k)
            sep = stack_se_params([blk])[0] if se else None
            plan = checked_entry_plan(x.shape, cm, se, dev)
            # Launches not overlapped: a device duration then holds no wait
            # for the call before it.
            new = lambda: fused_entry_kernel(x, params, sep, max_shift=k,
                                             overlap=False)
            timer.add(kind, f"{tag} {h}x{h}x{cin}->{cm}", 1, new,
                      lambda: fused_entry_plain(x, params, sep, max_shift=k),
                      entry_work(nb, h, cin, cm, 2, 2 + 3 * 3, se), bf,
                      kernels_per_call=2 + (plan.g is not None) + se,
                      note=f"; {entry_parts(new)}; plan: {plan.describe()}",
                      device=True)
        # K3-AQ beside what it replaced on the main path: the block's module
        # path (bn1, the attention shift, the 1x1 convs, the 2D shift
        # kernel) is its "plain" time.
        blk = random_block(cin, cm, 2, False, cpu_gen, dev, "rubiks3d-aq")
        params_aq = stack_entry_params_aq(blk, bf, k)
        plan = checked_entry_plan(x.shape, cm, False, dev, aq=True)

        def module_path(blk=blk, x=x):
            with torch.no_grad():
                return blk(x)

        new = lambda: fused_entry_kernel(x, params_aq, max_shift=k, aq=True,
                                         overlap=False)
        timer.add("fused_entry_aq", f"K3-AQ {h}x{h}x{cin}->{cm} (plain: the "
                  f"block's module path)", 1, new, module_path,
                  entry_work(nb, h, cin, cm, 2, 2 + 3 * 3, aq=True), bf,
                  kernels_per_call=2 + (plan.g is not None),
                  note=f"; {entry_parts(new)}; plan: {plan.describe()}",
                  device=True)
    # The shifts' backward kernels, summed over one train step's calls (one
    # input gradient and one shift gradient per shift), and the 2D shift
    # (Large-AQ: 51 per unfused forward and per train step).
    counts = [n for _, _, n in BLOCK_SHAPES] + [1] * len(ENTRY_SHAPES)
    plain2d_grad_ms = 0.0
    for (h, c, s), count in zip(SHIFT_SHAPES, counts):
        stride = (1, s, s)
        x_shape = (nb, FRAMES, h, h, c)
        og = randn(compute_output_shape_3d(x_shape, stride, (0, 0, 0)), bf,
                   gen, dev)
        x = randn(x_shape, bf, gen, dev)
        shift = torch.rand((3, c), generator=gen, device=dev) * 2 - 1
        # One call of the staged input gradient is one device kernel, one of
        # the staged shift gradient two (its partials, their sum): the
        # profiler holds them to that.
        timer.add("shift3d_inverse", f"K1-inverse {h}x{h}x{c} stride {s}",
                  count,
                  lambda: shift3d_input_grad_kernel(og, shift, x_shape,
                                                    stride),
                  lambda: shift3d_input_grad_plain(og, shift, x_shape,
                                                   stride),
                  shift_work(x.numel(), og.numel(), 2, 8), bf,
                  library_shift(og, shift, s, inverse=True), device=True)
        timer.add("shift_grad", f"K4 {h}x{h}x{c} stride {s}", count,
                  lambda: shift3d_shift_grad_kernel(og, x, shift, stride),
                  lambda: shift3d_shift_grad_plain(og, x, shift, stride),
                  shift_grad_work(og.numel(), x.numel(), 2), bf,
                  kernels_per_call=2, device=True)
        x4 = x.reshape((-1,) + x_shape[2:])
        og4 = og.reshape((-1,) + tuple(og.shape[2:]))
        shift2 = shift[1:].contiguous()
        timer.add("shift2d", f"shift2d {h}x{h}x{c} stride {s}", count,
                  lambda: shift2d.shift2d_kernel(x4, shift2, s),
                  lambda: shift2d.shift2d_plain(x4, shift2, s),
                  shift_work(og.numel(), x.numel(), 2, 4), bf,
                  library_shift(x4, shift2, s), device=True)
        timer.add("shift2d_inverse", f"shift2d_inverse {h}x{h}x{c} stride {s}",
                  count,
                  lambda: shift2d.shift2d_input_grad_kernel(og4, shift2,
                                                            x4.shape, s),
                  lambda: shift2d.shift2d_input_grad_plain(og4, shift2,
                                                           x4.shape, s),
                  shift_work(x.numel(), og.numel(), 2, 4), bf,
                  library_shift(og4, shift2, s, inverse=True), device=True)
        ms = cuda_time_ms(lambda: shift2d.rubiks_shift_2d_shift_grad(
            og4, x4, shift2, s))
        plain2d_grad_ms += count * ms
        print(f"  2D shift gradient (plain PyTorch, no kernel) {h}x{h}x{c} "
              f"stride {s}: {ms:.4f} ms (x{count} per train step)")
    time_gate(timer, gen, cpu_gen, dev)
    time_bn_relu(timer, dev, name, smi)
    time_stem(timer, gen, dev)
    for kind in timer.rows:
        backward = kind in ("shift3d_inverse", "shift_grad",
                            "shift2d_inverse", "bn_relu_train")
        timer.summary(kind, "train step" if backward else "forward")
    print(f"  2D shift gradient (plain PyTorch, no kernel): "
          f"{plain2d_grad_ms:.3f} ms per Large-AQ train step")
    # One call of either 2D shift wrapper, and of the staged forward and
    # input gradient of the 3D shift, is one device kernel and nothing else
    # (no cat, cast or copy); one of the staged shift gradient two; at every
    # shape the profiler recorded (Timer.add fails a call that launched
    # other).
    for prefixes, per_shape, names in (
            (("shift2d",), 2, "shift2d_kernel and shift2d_input_grad_kernel: "
             "1 device kernel per call"),
            (("K1 ",), 1, "shift3d_kernel (staged): 1 device kernel per "
             "call"),
            (("K1-inverse", "K4"), 2, "shift3d_input_grad_kernel and "
             "shift3d_shift_grad_kernel (staged): 1 and 2 device kernels per "
             "call")):
        missed = [m for m in PROFILER_MISSES
                  if "," not in m and m.startswith(prefixes)]
        timed = per_shape * len(SHIFT_SHAPES)
        seen = timed - len(missed)
        print(f"[launch] {names} by the profiler at {seen} of {timed} timed "
              f"shapes"
              + (f" (no profiler records at: {missed})" if missed else ""))
        if seen == 0:
            fail(f"the profiler recorded no call of {names}")


def se_partial_pairs(plan, shape):
    """The (row tile, frame slot) pairs launch A writes for mid of ``shape``
    under ``plan``: each tile's frames."""
    n, t, h, w, _ = shape
    m, hw, bm = n * t * h * w, h * w, plan.rows
    first = torch.arange(-(-m // bm)) * bm
    last = torch.clamp(first + bm, max=m) - 1
    return int((last // hw - first // hw + 1).sum())


def time_gate(timer, gen, cpu_gen, dev):
    """The SE gate per SE block of Small at batch TIME_BATCH, bf16, and
    summed over one Small forward (the se_gate row): device ms by the
    profiler, launches not overlapped, of the gate launch and of launch A
    with the gate's sums and without them (what the sums add to it); the
    plain gate of the same mid (se_gate of its shift) by events. The row's
    time is the gate launch plus what the sums add to launch A. Bound: the
    partials launch A writes, fc1, fc2 and the T taps read once and the
    gate written; one multiply-add per element of mid, the fc products and
    the taps."""
    from rubiksnet_torch.ops import fused_block as fb
    from rubiksnet_torch.ops import fused_entry as fe
    from rubiksnet_torch.utils import cuda_time_ms
    from rubiksnet_torch.utils import fused_block_probe as k2probe
    from rubiksnet_torch.utils import fused_entry_probe as k3probe

    bf, nb, k = torch.bfloat16, TIME_BATCH, MAX_SHIFT
    print(f"[timing] the SE gate per SE block of Small, batch {nb} bf16, "
          f"device ms by the profiler, launches not overlapped")
    small_counts = {h: n for h, _, n in SMALL_BLOCK_SHAPES}
    cases = ([("K2-SE", h, c, c, small_counts[h])
              for h, c, _ in SMALL_BLOCK_SHAPES]
             + [("K3-SE", h, cin, cm, 1) for h, cin, cm in ENTRY_SHAPES])
    tot = dict.fromkeys(("new", "added", "plain", "bytes", "ops"), 0.0)
    for tag, h, cin, cm, count in cases:
        scratch = {}
        if tag == "K2-SE":
            vt, wm, sep = k2probe.make_run(cm, 1, False, True, bf, k, "frac",
                                           cpu_gen, dev)
            x = randn((nb, FRAMES, h, h, cm), bf, gen, dev)
            plan = checked_plan(x.shape, False, True, dev).a

            def call(se=sep):
                return fb.fused_block_kernel(x, vt, wm, se, max_shift=k,
                                             overlap=False, scratch=scratch)
            taps, se1, stride = vt[0, 4:], sep[0], 1
            a_se, a_bare = "rubiks_tc_kernel<5>", "rubiks_tc_kernel<0>"
        else:
            params, sep = k3probe.make_entry(cin, cm, True, bf, k, "frac",
                                             cpu_gen, dev)
            x = randn((nb, FRAMES, h, h, cin), bf, gen, dev)
            plan = checked_entry_plan(x.shape, cm, True, dev).a

            def call(se=sep):
                return fe.fused_entry_kernel(x, params, se, max_shift=k,
                                             overlap=False, scratch=scratch)
            taps, se1, stride = params[1][2:], sep, 2
            a_se = "rubiks_entry_tc_kernel<7>"
            a_bare = "rubiks_entry_tc_kernel<3>"
        label = f"{tag} {h}x{h}x{cin}->{cm}"
        new = profiled_ms(call, "se_gate_tc_kernel", f"{label} gate")[0]
        added = (profiled_ms(call, a_se, f"{label} A with sums")[0]
                 - profiled_ms(lambda: call(se=None), a_bare,
                               f"{label} A")[0])
        call()
        # K2's mid, taps and SE weights are all in the folded channel order
        # (make_run's), so the plain gate is in the kernel's order too.
        mid = scratch["mid"]
        plain = cuda_time_ms(lambda: fb.se_gate(fb.tap_shift(
            mid.float(), taps, k)[:, :, ::stride, ::stride], se1))
        shape = (nb, FRAMES, h, h, cm)
        frames, cr = nb * FRAMES, se1.shape[-1]
        pairs = se_partial_pairs(plan, shape)
        nbytes = 4 * (pairs * cm + 2 * cm * cr + taps.shape[0] // 3 * cm
                      + frames * cm)
        ops = (2 * mid.numel() + pairs * cm
               + frames * (4 * cm * cr + 4 * cm))
        for key, v in (("new", new), ("added", added), ("plain", plain),
                       ("bytes", nbytes), ("ops", ops)):
            tot[key] += count * v
        bound = max(1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_F32)
        print(f"  {label} (x{count} per Small forward): gate launch {new:.4f}"
              f" ms, launch A with the sums {added:+.4f} ms against without;"
              f" plain {plain:.4f} ms; bound {bound:.4f} ms; plan "
              f"{plan.describe()}")
    # Every time of this row is the device's (the gate launches inside K2's
    # and K3's calls, so events cannot time them apart).
    row = timer.rows["se_gate"]
    whole = tot["new"] + tot["added"]
    row.update(ms=whole, plain_ms=tot["plain"], device_ms=whole,
               bytes_ms=1e3 * tot["bytes"] / HBM_BYTES_PER_S,
               ops_ms=1e3 * tot["ops"] / PEAK_F32)
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    row["launch_a_added_ms"] = tot["added"]
    print(f"  SE gate over Small's 17 SE blocks: gate launches "
          f"{tot['new']:.4f} ms + launch A's sums {tot['added']:.4f} ms = "
          f"{whole:.4f} ms; bound {row['bound_ms']:.4f} ms (bytes "
          f"{row['bytes_ms']:.4f}, "
          f"operations {row['ops_ms']:.4f}); plain {tot['plain']:.4f} ms")


# ------------------------------------------------------------ the models


def build_models(tier, variant, dev):
    """The f32 and bf16 models of one configuration, seed 0, BN statistics
    randomized."""
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet

    models = {}
    for dt in (torch.float32, torch.bfloat16):
        m = create_rubiksnet(tier, CLASSES, FRAMES, variant,
                             max_shift=MAX_SHIFT, dtype=dt, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        models[dt] = randomize_bn(m, torch.Generator().manual_seed(1)).to(dev)
    return models


def check_logits(label, models, video):
    """Fused executor and unfused module path against the plain model."""
    from rubiksnet_torch.models.fused_infer import FusedExecutor

    print(f"[model] RubiksNet-{label}, random init (seed 0), BN stats "
          f"randomized")
    with torch.no_grad():
        for dt, tol in ((torch.float32, TOL_MODEL_F32),
                        (torch.bfloat16, TOL_MODEL_BF16)):
            m = models[dt]
            ref = m(video, plain=True)
            routes = {"fused executor": FusedExecutor(m)(video),
                      "unfused forward": m(video)}
            for route, got in routes.items():
                if got.shape != (video.shape[0], CLASSES) or not (
                        torch.isfinite(got.float()).all()):
                    fail(f"{label} {route} {dt}: bad logits "
                         f"{tuple(got.shape)}")
                _, _, rel_l2 = errors(got, ref)
                ok = rel_l2 <= tol
                print(f"  {route} vs plain model, {str(dt)[6:]}: logits "
                      f"rel_l2={rel_l2:.3e} [<= {tol}] "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"{label} {route} {dt} logits outside tolerance")


def counted(fn):
    """The launch counts of ``fn()``, every counter set to 0 just before it
    and read just after."""
    from rubiksnet_torch.ops import launch_counters

    counters = launch_counters()
    for ctr in counters.values():
        ctr.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.count for k, c in counters.items()}


def main_path(label, model, batch, want_fused, want_unfused):
    """One batch through the fused executor, then through the unfused module
    path, each counted; returns (executor, fused counts, unfused counts)."""
    from rubiksnet_torch.models.fused_infer import FusedExecutor

    executor = FusedExecutor(model)
    zero = dict.fromkeys(LAUNCH_COUNTERS, 0)
    with torch.no_grad():
        fused_logits, fused = counted(lambda: executor(batch))
        unfused_logits, unfused = counted(lambda: model(batch))
    print(f"[main path] {label}: launches of the fused forward {fused}; of "
          f"the unfused forward {unfused}")
    if fused != k2_ring(dict(zero, **want_fused)):
        fail(f"{label} fused forward launches {fused} != {want_fused}")
    if unfused != dict(zero, **want_unfused):
        fail(f"{label} unfused forward launches {unfused} != {want_unfused}")
    for route, lg in (("fused", fused_logits), ("unfused", unfused_logits)):
        if lg.shape != (batch.shape[0], CLASSES) or not torch.isfinite(
                lg.float()).all():
            fail(f"{label} main path {route} logits bad: {tuple(lg.shape)}")
    _, _, rel = errors(fused_logits, unfused_logits)
    print(f"  fused vs unfused logits, bf16: rel_l2={rel:.3e}")
    if rel > TOL_MODEL_BF16:
        fail(f"{label}: fused and unfused main-path logits disagree")
    return executor, fused, unfused


def serve_phase(label, executor, model, gen, dev, name, smi, aq, se):
    """Serving: each call answers one batch; its device time comes from CUDA
    events around it (median, min and max of SERVE_ITERS calls). Every K2
    and K3 plan of a served batch must have passed its comparison with the
    plain version at that shape (``aq``, ``se``: the configuration's K2 and
    K3 form)."""
    print(f"[serve] {label} fused executor, bf16, {FRAMES}x{SIZE}x{SIZE}, "
          f"{name} ({smi})")
    for bs in SERVE_BATCHES:
        plans = [f"{h}x{h}x{c} " + checked_plan(
            (bs, FRAMES, h, h, c), aq, se, dev).describe()
                 for h, c, _ in BLOCK_SHAPES]
        print(f"  K2 plans at batch {bs}, each checked against plain: "
              + "; ".join(plans))
        entries = [f"{h}x{h}x{cin}->{cm} " + checked_entry_plan(
            (bs, FRAMES, h, h, cin), cm, se, dev, aq).describe()
                   for h, cin, cm in ENTRY_SHAPES]
        print(f"  K3 plans at batch {bs}, each checked against plain: "
              + "; ".join(entries))

    def serve(route, fn, bs):
        ms = sorted(cuda_call_times_ms(fn, iters=SERVE_ITERS, warmup=2))
        med = ms[len(ms) // 2]
        print(f"  {label} {route} batch {bs}: median {med:.3f} ms/batch "
              f"(min {ms[0]:.3f}, max {ms[-1]:.3f}, n={len(ms)}), "
              f"{bs * 1000.0 / med:.1f} clips/s ({name}, {smi})")

    with torch.no_grad():
        for bs in SERVE_BATCHES:
            clips = torch.randn((bs, FRAMES, SIZE, SIZE, 3), generator=gen,
                                device=dev)
            serve("fused executor", lambda: executor(clips), bs)
        clips = torch.randn((8, FRAMES, SIZE, SIZE, 3), generator=gen,
                            device=dev)
        serve("plain model", lambda: model(clips, plain=True), 8)


def small_aq_check(dev, gen):
    """The SE tier with the rubiks3d-aq variant (both options through one K2
    call) at a small size, 4 frames, 64 px: float32 (the SIMT route, the
    gate of se_gate.cuh) and bfloat16 (the tensor-core route: launch A-AQ
    with the gate's sums, one gate launch a block)."""
    from rubiksnet_torch.models.fused_infer import FusedExecutor
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet

    video = torch.randn((2, 4, 64, 64, 3), generator=gen, device=dev)
    for dt, tol, gates in ((torch.float32, TOL_MODEL_F32, 0),
                           (torch.bfloat16, TOL_MODEL_BF16, 13)):
        m = create_rubiksnet("small", CLASSES, 4, "rubiks3d-aq",
                             max_shift=MAX_SHIFT, dtype=dt, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        m = randomize_bn(m, torch.Generator().manual_seed(1)).to(dev)
        with torch.no_grad():
            ref = m(video, plain=True)
            got, counts = counted(lambda: FusedExecutor(m)(video))
        _, _, rel = errors(got, ref)
        # K3 takes no SE gate with the attention mix: the entries stay on
        # the module path, their 2D shift on shift2d.
        ok = (rel <= tol and counts["fused_block"] == 13
              and counts["shift2d"] == 4 and counts["fused_entry"] == 0
              and counts["fused_entry_aq"] == 0
              and counts["se_gate"] == gates
              and bool(torch.isfinite(got.float()).all()))
        print(f"[model] Small rubiks3d-aq (SE and AQ together), 4x64x64, "
              f"{str(dt)[6:]}: fused vs plain logits rel_l2={rel:.3e} "
              f"[<= {tol}], launches {counts} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"Small rubiks3d-aq fused forward failed in {dt}")


@contextlib.contextmanager
def executors_built():
    """The FusedExecutors constructed inside the block, in a list."""
    from rubiksnet_torch.models.fused_infer import FusedExecutor

    built, init = [], FusedExecutor.__init__

    def counting_init(self, model):
        built.append(self)
        init(self, model)

    FusedExecutor.__init__ = counting_init
    try:
        yield built
    finally:
        FusedExecutor.__init__ = init


def eval_log(*parts):
    """The evaluator's log lines, indented; its per-class array left out."""
    if parts and isinstance(parts[0], str):
        for line in " ".join(map(str, parts)).strip("\n").splitlines():
            print("  |", line)


def first_batch_vs_plain(label, args, result, bs, views, model, dev):
    """The run's first batch rebuilt through the evaluator's own dataset,
    normalized on the device and put through the plain model; its
    view-averaged logits against the run's (bf16, TOL_MODEL_BF16)."""
    from rubiksnet_torch.data import (
        batch_iterator,
        device_batches_from_files,
    )
    from rubiksnet_torch.models import INPUT_MEAN, INPUT_STD
    from rubiksnet_torch.scripts import test_models

    ds = test_models.build_dataset(args, log=lambda *a: None)[0]
    if args.loader == "device":
        batch = next(iter(device_batches_from_files(ds, bs, views, FRAMES,
                                                    device=dev)))
        video, _ = batch.take()
        valid = batch.valid
    else:
        host, _, valid = next(iter(batch_iterator(ds, bs, views, FRAMES)))
        video = torch.from_numpy(host).to(dev)
    n = int(valid.sum())
    flat = video.reshape((bs * views,) + tuple(video.shape[2:]))
    mean = torch.tensor(INPUT_MEAN, device=dev)
    std = torch.tensor(INPUT_STD, device=dev)
    with torch.no_grad():
        ref = model((flat.float() * (1.0 / 255.0) - mean) / std, plain=True)
    ref = ref.float().reshape(bs, views, -1).mean(1)[:n]
    got = torch.from_numpy(result["logits"][:n]).to(dev)
    _, _, rel = errors(got, ref)
    ok = rel <= TOL_MODEL_BF16
    print(f"  {label} first batch ({n} videos x {views} views) vs the plain "
          f"model on the same normalized clips, bf16: logits rel_l2="
          f"{rel:.3e} [<= {TOL_MODEL_BF16}] {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"evaluator {label}: first-batch logits outside tolerance")


def loaders_agree(args, videos=4):
    """The native loader's uint8 clips against the PIL path's on the first
    ``videos`` videos: at most 1 apart per pixel."""
    from rubiksnet_torch.scripts import test_models

    def clips(loader):
        a = argparse.Namespace(**dict(vars(args), loader=loader,
                                      limit=videos))
        return [c for c, _ in test_models.build_dataset(
            a, log=lambda *p: None)[0]]

    import numpy as np

    return max(int(np.abs(n.astype(np.int16) - p.astype(np.int16)).max())
               for n, p in zip(clips("native"), clips("pil")))


def loader_jpegs(seed=0, quality=90):
    """LOADER_COPIES JPEGs of each LOADER_FRAMES size, smooth content from
    ``seed`` (a low-resolution random base resized bilinear, as the data
    benches write), as byte strings."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    blobs = []
    for w, h, _ in LOADER_FRAMES:
        for _ in range(LOADER_COPIES):
            base = rng.randint(0, 255, (h // 8, w // 8, 3)).astype(np.uint8)
            img = Image.fromarray(base).resize((w, h), Image.BILINEAR)
            buf = io.BytesIO()
            img.save(buf, format="JPEG", quality=quality)
            blobs.append(buf.getvalue())
    return blobs


def loader_origins(sizes, crops):
    """Per frame its protocol's crop origins at scale SCALE: the center
    crop (1) or the 3 full-resolution crops, as the evaluation datasets
    compute them."""
    from rubiksnet_torch.data import device_loader
    from rubiksnet_torch.data.native_eval import (
        center_offset,
        full_res_offsets,
    )

    out = []
    for w, h, _ in sizes.tolist():
        rw, rh = device_loader.resized_size(w, h, EVAL_SCALE)
        out.append(full_res_offsets(rw, rh, SIZE) if crops == 3
                   else [center_offset(rw, rh, SIZE)])
    return out


def check_loader(dev, name, smi):
    """Phase 7 (a)-(c): the probe, nvjpeg's decode of LOADER_FRAMES against
    Pillow's (per channel, DECODE_BOUND), and resize_crop_u8 against its
    plain version on that decode, 1 and 3 crops, every frame size in one
    batch, bit-identical (and the kernel twice bit-identically). Returns
    the kernel's largest |error| (0)."""
    from rubiksnet_torch.data import device_loader as dl

    probe = dl.probe()
    print(f"[loader] nvjpeg probe: {json.dumps(probe)}")
    blobs = loader_jpegs()
    dl.reset_counts()
    rgb, sizes = dl.decode_batch(blobs, dev)
    torch.cuda.synchronize()
    rgb = rgb.clone()
    print(f"[loader] (a) {len(blobs)} frames decoded; frames by backend "
          f"{dict(dl.BACKEND_FRAMES)}; the hardware backend's "
          f"nvjpegCreateEx status {dl.decoder_for(dev).hw_status} (0 = "
          f"started; 7 = NVJPEG_STATUS_ARCH_MISMATCH), the other frames' "
          f"route {dl.FALLBACK_ROUTE}")
    decode_ok = True
    for j, (w, h, what) in enumerate(LOADER_FRAMES):
        idx = range(j * LOADER_COPIES, (j + 1) * LOADER_COPIES)
        got = [rgb[int(sizes[i, 2]):int(sizes[i, 2]) + w * h * 3].view(
            h, w, 3).cpu().numpy() for i in idx]
        ref = [dl.plain_decode(blobs[i]) for i in idx]
        d = dl.decode_diff(got, ref)
        ok = d["within_bound"] and all(
            tuple(sizes[i, :2]) == (w, h) for i in idx)
        print(f"  (c) nvjpeg vs Pillow, {w}x{h} ({what}), scale 0: mean "
              f"|diff| per channel {[round(v, 4) for v in d['mean_abs_diff']]}"
              f", max {d['max_abs_diff']} [mean <= "
              f"{dl.DECODE_BOUND['mean']}, max <= {dl.DECODE_BOUND['max']}] "
              f"{'ok' if ok else 'FAIL'}")
        decode_ok = decode_ok and ok
    if not decode_ok:
        fail("nvjpeg's decode outside the bound of Pillow's")
    for crops in (1, 3):
        origins = loader_origins(sizes, crops)
        ref = dl.plain_resize_crop(rgb, sizes, EVAL_SCALE, SIZE, origins,
                                   group=LOADER_COPIES)
        got = dl.resize_crop(rgb, sizes, EVAL_SCALE, SIZE, origins,
                             group=LOADER_COPIES)
        again = dl.resize_crop(rgb, sizes, EVAL_SCALE, SIZE, origins,
                               group=LOADER_COPIES)
        torch.cuda.synchronize()
        same = torch.equal(got, ref) and torch.equal(got, again)
        worst = int((got.int() - ref.int()).abs().max())
        print(f"  (b) resize_crop_u8 vs plain_resize_crop, "
              f"{crops} crop{'s' if crops > 1 else ''} a frame, "
              f"{len(blobs)} frames of {len(LOADER_FRAMES)} sizes in one "
              f"launch, scale {EVAL_SCALE}, crop {SIZE}: max |diff| "
              f"{worst}, {'bit-identical' if same else 'DIFFER'} (rerun "
              f"included)")
        if not same:
            fail(f"resize_crop_u8 differs from its plain version ({crops} "
                 f"crops)")
    return 0


def time_loader_kernel(dev, launches, name, smi):
    """resize_crop_u8's row of the JSON line, returned. At each shape of
    ``resize_crop_probe.SHAPES`` (the evaluator's 1-clip batch of 427x240
    frames, resized to 455x256: the row's own keys; of its 340x256 frames,
    only cropped: copy_*; its 2-clip batch of 427x240, 3 crops a frame:
    clip2_*), random frames packed as the decoder packs them: the staged
    kernel held to plain bit for bit, then timed by events around the
    wrapper's calls (its host work included) and its launch alone
    (``resize_crop_launch``) on the device by the profiler
    (``device_ms_by`` says where events stood in), the plain version, the
    bound, and the library's version (``resize_crop_probe.
    library_version``: F.interpolate with antialias, or the sliced copy)
    by events and on the device, with its largest difference to the kernel
    (informational)."""
    from rubiksnet_torch.data import device_loader as dl
    from rubiksnet_torch.utils import cuda_time_ms
    from rubiksnet_torch.utils.resize_crop_probe import (
        SHAPES,
        batch,
        library_version,
    )
    from rubiksnet_torch.utils.roofline import (
        resize_crop_bound_ms,
        resize_crop_work,
    )

    row = {}
    for key, (label, w, h, frames, crops, group) in zip(
            ("copy_", "", "clip2_"), SHAPES):
        rgb, sizes, origins = batch(dev, w, h, frames, crops)
        ref = dl.plain_resize_crop(rgb, sizes, EVAL_SCALE, SIZE, origins,
                                   group)

        def kernel():
            return dl.resize_crop(rgb, sizes, EVAL_SCALE, SIZE, origins,
                                  group)

        if not torch.equal(kernel(), ref):
            fail(f"resize_crop_u8 differs from plain at {label}")
        ms = cuda_time_ms(kernel)
        # The kernel alone: its launch, the wrapper's work done once.
        launch, _ = dl.resize_crop_launch(rgb, sizes, EVAL_SCALE, SIZE,
                                          origins, group)
        dev_ms, seen = profiled_ms(launch, "resize_crop_u8",
                                   f"resize_crop_u8 {label}", expect=1)
        by = "profiler" if seen is not None else "events"
        plain_ms = cuda_time_ms(lambda: dl.plain_resize_crop(
            rgb, sizes, EVAL_SCALE, SIZE, origins, group), iters=2,
            warmup=1)
        library = library_version(rgb, sizes, origins)
        k = len(origins[0])
        # The library's output is crop-major over all frames; the kernel's
        # is crop-major within each group of frames.
        order = (torch.arange(len(sizes) * k).view(k, -1, group)
                 .permute(1, 0, 2).reshape(-1))
        lib_diff = int((library()[order.to(dev)].int() - ref.int()).abs()
                       .max())
        lib_ms = cuda_time_ms(library)
        lib_dev_ms, lib_seen = profiled_ms(library, "",
                                           f"library resize {label}")
        tb, to = resize_crop_bound_ms(resize_crop_work(
            sizes, EVAL_SCALE, SIZE, origins))
        bound = max(tb, to)
        lib_by = "profiler" if lib_seen is not None else "events"
        row.update({f"{key}ms": ms, f"{key}device_ms": dev_ms,
                    f"{key}device_ms_by": by,
                    f"{key}plain_ms": plain_ms,
                    f"{key}bound_ms": bound,
                    f"{key}bound_by": "bytes" if tb >= to else "operations",
                    f"{key}library_ms": lib_ms,
                    f"{key}library_device_ms": lib_dev_ms,
                    f"{key}library_device_ms_by": lib_by,
                    f"{key}frames": f"{frames} of {w}x{h}, {crops} crop"
                                    f"{'s' if crops > 1 else ''} a frame"})
        what = ("F.interpolate(bilinear, antialias) on the resized frame, "
                "the crops and the casts" if dl.resizes(w, h, EVAL_SCALE)
                else "the sliced copy")
        print(f"[loader] resize_crop_u8, {label} ({frames} frames x {crops} "
              f"crop{'s' if crops > 1 else ''}, group {group}), scale "
              f"{EVAL_SCALE}, crop {SIZE}: staged {dev_ms:.4f} ms on the "
              f"device (by the {by}; {bound / dev_ms:.1%} of the bound), "
              f"{ms:.4f} ms by events around the wrapper's calls (its host "
              f"work included); plain {plain_ms:.4f} ms; library ({what}) "
              f"{lib_dev_ms:.4f} ms on the device (by the {lib_by}), "
              f"{lib_ms:.4f} ms by events, max |diff| to the "
              f"kernel {lib_diff} (informational); bound {bound:.4f} ms "
              f"({'bytes' if tb >= to else 'operations'}; bytes {tb:.4f}, "
              f"float64 operations {to:.4f}) ({name}, {smi})")
    return {
        "name": "resize_crop_u8", "route": "cuda",
        "source": "rubiksnet_torch/data/csrc/device_loader.cu",
        "replaces": "native/rubiks_loader.cpp:121", "launches": launches,
        "max_abs_err": 0, **row}


def eval_runs(label, two_clips, bs, views, runs, ckpt, list_file, root, dev,
              name, smi, plain):
    """One protocol of the evaluator over one video set, a run for each
    (loader, --prefetch) of ``runs``: launches counted and checked (K2 47
    and K3 4 a batch, one executor, one resize_crop_u8 a batch with the
    device loader), logits finite, stats printed; then for each loader its
    first batch against the plain model and its logits of --prefetch 2
    and 0 bit-identical. Returns ({run: result}, {run: parsed arguments},
    resize_crop_u8 launches)."""
    from rubiksnet_torch.data import device_loader
    from rubiksnet_torch.scripts import eval_throughput, test_models

    results, argv, launches = {}, {}, 0
    proto = label.split()[0].replace("-", "")
    for run in runs:
        loader, depth = run
        argv[run] = test_models.build_parser().parse_args(
            eval_throughput.evaluator_args(
                ckpt, list_file, root, CLASSES, FRAMES, bs, two_clips,
                loader=loader, prefetch=depth))
        device_loader.reset_counts()
        with executors_built() as built:
            result, counts = counted(lambda: test_models.evaluate(
                argv[run], log=eval_log if run == runs[0]
                else lambda *a: None))
        results[run] = result
        st, batches = result["stats"], result["batches"]
        want = dict.fromkeys(counts, 0)
        want.update(fused_block=47 * batches, fused_entry=4 * batches,
                    stem_conv=batches)
        want = k2_ring(want)
        resizes = device_loader.LAUNCHES.count
        lg = result["logits"]
        print(f"  {label} {loader} --prefetch {depth}: {batches} batches, "
              f"executors built {len(built)}, launches {counts} (K2 "
              f"{counts['fused_block'] / batches:g}, K3 "
              f"{counts['fused_entry'] / batches:g} a batch), resize_crop_u8"
              f" {resizes}, frames by decode route "
              f"{dict(device_loader.BACKEND_FRAMES)}")
        if counts != want or len(built) != 1 or st["loader"] != loader:
            fail(f"evaluator {label} {loader}: launches {counts} != {want}, "
                 f"{len(built)} executors or loader {st['loader']}")
        if resizes != (batches if loader == "device" else 0):
            fail(f"evaluator {label} {loader}: {resizes} resize_crop_u8 "
                 f"launches in {batches} batches")
        launches += resizes
        if lg.shape != (EVAL_VIDEOS, CLASSES) or not (
                torch.isfinite(torch.from_numpy(lg)).all()):
            fail(f"evaluator {label}: bad logits {lg.shape}")
        print(f"[eval] {label}, batch {bs} ({bs * views} clips), {loader} "
              f"loader, --prefetch {depth}: {st['sec_per_video']:.5f} "
              f"s/video ({st['videos']} videos in {st['wall_s']:.3f} s, "
              f"first batch {st['first_batch_s']:.3f} s), steady "
              f"{st['steady_videos_per_s']:.2f} videos/s "
              f"({st['steady_sec_per_video']:.5f} s/video), host-wait share "
              f"{st['host_wait_frac']:.3f}, device step+fetch share "
              f"{st['device_frac']:.3f} ({name}, {smi}); the reference's "
              f"eval log: "
              f"{eval_throughput.REFERENCE_SEC_PER_VIDEO[proto]} s/video "
              f"(unspecified GPU)")
    for loader in dict.fromkeys(loader for loader, _ in runs):
        first_batch_vs_plain(f"{label} {loader}", argv[(loader, 2)],
                             results[(loader, 2)], bs, views, plain, dev)
        same = (results[(loader, 2)]["logits"]
                == results[(loader, 0)]["logits"]).all()
        print(f"  {label}: {loader} loader logits of --prefetch 2 and "
              f"--prefetch 0 {'bit-identical' if same else 'DIFFER'}")
        if not same:
            fail(f"evaluator {label} {loader}: --prefetch 2 and 0 disagree")
    return results, argv, launches


def eval_phase(dev, name, smi):
    """The evaluator end to end on RubiksNet-Large, bf16, 8 frames at 224:
    first the device loader's kernel and decode (``check_loader``), then a
    random checkpoint (seed 0, BN statistics randomized) and each protocol
    run through ``test_models.evaluate`` as a user runs it (uint8 clips
    normalized on the device, one held executor): over EVAL_VIDEOS
    synthetic SSv2-like videos (340x256 JPEGs at quality 87, 24-48 frames,
    seed 0) (d) with --loader device and (e) with the host's loader (native
    where g++ finds libjpeg, else PIL), each at --prefetch 2 and 0, and (f)
    the two loaders' logits compared; then over EVAL_VIDEOS videos of the
    data bench's frames (427x240 at quality 95, 2 x FRAMES frames, which
    the device loader resizes) (d) again. Returns resize_crop_u8's
    launches in the device runs."""
    import tempfile

    from rubiksnet_torch.data import native_loader
    from rubiksnet_torch.models import load_pretrained, save_pretrained
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet
    from rubiksnet_torch.scripts import data_pipeline_bench, eval_throughput

    if importlib.util.find_spec("PIL") is None:
        fail("Pillow is missing: the evaluator phase cannot write its frames")
    check_loader(dev, name, smi)
    native = native_loader.toolchain_present()
    host = "native" if native else "pil"
    print(f"[eval] the evaluator, RubiksNet-Large bf16, {FRAMES}x{SIZE}x"
          f"{SIZE}, {EVAL_VIDEOS} synthetic videos, loaders device and "
          f"{host} ({name}, {smi})")
    if not native:
        print("[eval] host loader: pil, because g++ finds no libjpeg header "
              "or library on this machine; the native loader is held "
              "against the PIL path on the CPU only (tests/test_torch_"
              "native_loader.py)")
    for clips in EVAL_CLIPS:
        plans = [f"{h}x{h}x{c} " + checked_plan(
            (clips, FRAMES, h, h, c), False, False, dev).describe()
                 for h, c, _ in BLOCK_SHAPES]
        entries = [f"{h}x{h}x{cin}->{cm} " + checked_entry_plan(
            (clips, FRAMES, h, h, cin), cm, False, dev).describe()
                   for h, cin, cm in ENTRY_SHAPES]
        print(f"  K2 and K3 plans at {clips} clips, each checked against "
              f"plain: " + "; ".join(plans + entries))
    launches = 0
    with tempfile.TemporaryDirectory(prefix="rubiks_eval_") as root:
        t0 = time.perf_counter()
        list_file = eval_throughput.generate_frames(root, EVAL_VIDEOS,
                                                    CLASSES, seed=0)
        resized_root = os.path.join(root, "resized")
        resized_list = data_pipeline_bench.make_frames(
            resized_root, EVAL_VIDEOS, 2 * FRAMES)
        model = create_rubiksnet("large", CLASSES, FRAMES,
                                 max_shift=MAX_SHIFT, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
        randomize_bn(model, torch.Generator().manual_seed(1))
        ckpt = f"{root}/large.pth.tar"
        save_pretrained(model, ckpt)
        plain = load_pretrained(ckpt, device=dev, dtype=torch.bfloat16)
        print(f"  wrote the videos and the checkpoint in "
              f"{time.perf_counter() - t0:.1f} s")
        both = (("device", 2), ("device", 0), (host, 2), (host, 0))
        for label, two_clips, bs, views in EVAL_PROTOCOLS:
            results, argv, n = eval_runs(label, two_clips, bs, views, both,
                                         ckpt, list_file, root, dev, name,
                                         smi, plain)
            launches += n
            dev2 = results[("device", 2)]["logits"]
            other = results[(host, 2)]["logits"]
            agree = float((dev2.argmax(1) == other.argmax(1)).mean())
            _, _, rel = errors(torch.from_numpy(dev2),
                               torch.from_numpy(other))
            print(f"  {label}: device vs {host} loader logits (random "
                  f"weights, informational): max |diff| "
                  f"{float(np.abs(dev2 - other).max()):.4e}, rel_l2 "
                  f"{rel:.3e}, top-1 agreement {agree:.4f}")
            if native:
                worst = loaders_agree(argv[(host, 2)])
                print(f"  {label}: native vs PIL uint8 clips, 4 videos: max "
                      f"|diff| {worst} [<= 1] {'ok' if worst <= 1 else 'FAIL'}")
                if worst > 1:
                    fail(f"evaluator {label}: native and PIL clips differ")
        print(f"[eval] the device loader over {EVAL_VIDEOS} videos of "
              f"{data_pipeline_bench.FRAME_SIZE[0]}x"
              f"{data_pipeline_bench.FRAME_SIZE[1]} frames (the data bench's, "
              f"resized to 455x256 before the crops)")
        for label, two_clips, bs, views in EVAL_PROTOCOLS:
            _, _, n = eval_runs(f"{label} 427x240", two_clips, bs, views,
                                (("device", 2), ("device", 0)), ckpt,
                                resized_list, resized_root, dev, name, smi,
                                plain)
            launches += n
        del plain
    return launches


# Phase 9: the training entry points, Large rubiks3d at full width, float32
# (the scripts' default), 8x224x224, batch 8. (a) synthetic data with a
# cosine schedule, checkpoints and validation, then --resume; (b) the
# registry path over synthetic SSv2-like videos; (c) the evaluator on (b)'s
# final weights; (d) example_finetune; (e) the executor's per-shape route
# at 112 px, Small's route at the default max_shift, and the SE
# shared-memory rule at its edge.
TRAIN_SCRIPT_BATCH, TRAIN_SCRIPT_STEPS, TRAIN_SCRIPT_RESUME = 8, 4, 2
# (b) runs long enough for the prefetch queue, filled while the first step
# builds, to drain: 16 steps of 8.
REGISTRY_TRAIN, REGISTRY_VAL = 128, 8
ROUTE_SIZE = 112  # the last entry block meets 7 x 7 there


def run_stats(label, step_s, wait_s, batch, peak_bytes, name, smi):
    """The median step, the clips/s and the host-wait share (the waits'
    share of those steps' wall clock) over the steps after the first
    (``utils.profiling.step_stats``), the first step and its wait, peak
    device memory. Fewer than STEADY_MIN_STEPS steps after the first are
    printed as not steady."""
    from rubiksnet_torch.utils.profiling import STEADY_MIN_STEPS, step_stats

    st = step_stats(step_s, wait_s, batch)
    kind = ("steady" if st["steady"] else
            f"NOT steady, fewer than {STEADY_MIN_STEPS} steps")
    print(f"[train script] {label}: {len(step_s)} steps; over the "
          f"{st['steps']} after the first ({kind}): median step "
          f"{st['median_s'] * 1e3:.3f} ms, {st['clips_s']:.2f} train "
          f"clips/s, host-wait share {st['host_wait_frac']:.4f} (waits "
          f"{' '.join(f'{w:.4f}' for w in wait_s[1:])} s); first step "
          f"{st['first_s'] * 1e3:.1f} ms, its wait "
          f"{st['first_wait_s']:.3f} s; peak device memory "
          f"{peak_bytes / 2**30:.2f} GiB ({name}, {smi})")


def step_alone(model, step_s, batch, dev, gen, name, smi, warm=2, timed=5):
    """The f32 train step of ``model`` with no feed beside it: one batch
    already on the card, ``warm`` + ``timed`` steps, each timed on the host
    clock up to reading its loss as the script times its steps; printed
    beside the median of ``step_s`` after the first, so the difference is
    what the feed's thread costs inside the step besides its waits."""
    from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult
    from rubiksnet_torch.utils.profiling import step_stats

    step = make_train_step(model, sgd_with_shift_mult(model, 1e-3))
    video = torch.rand((batch, FRAMES, SIZE, SIZE, 3), generator=gen,
                       device=dev)
    labels = torch.arange(batch, device=dev) % CLASSES
    times = []
    for _ in range(warm + timed):
        t0 = time.perf_counter()
        float(step(video, labels)["loss"])
        times.append(time.perf_counter() - t0)
    alone = sorted(times[warm:])[timed // 2]
    fed = step_stats(step_s, [0.0] * len(step_s), batch)["median_s"]
    print(f"[train script] the same f32 step with no feed, {timed} after "
          f"{warm} warm-up: median {alone * 1e3:.3f} ms (min "
          f"{min(times[warm:]) * 1e3:.3f}, max {max(times[warm:]) * 1e3:.3f})"
          f"; the fed run's median {fed * 1e3:.3f} ms, {(fed - alone) * 1e3:.3f}"
          f" ms more ({name}, {smi})")


def check_train_launches(label, counts, steps, val_batches):
    """51 K1 a forward (train steps and validation batches), 51 K1-inverse
    and K4 and BN_SITES of the BN pair each way a train step, nothing
    else."""
    want = dict.fromkeys(counts, 0)
    want.update(shift3d=51 * (steps + val_batches),
                shift3d_inverse=51 * steps, shift_grad=51 * steps,
                bn_relu_train=BN_SITES * steps,
                bn_relu_train_backward=BN_SITES * steps)
    print(f"  {label}: launches {counts} for {steps} train steps and "
          f"{val_batches} validation batches "
          f"{'ok' if counts == want else 'FAIL'}")
    if counts != want:
        fail(f"{label}: launches {counts} != {want}")


def finite_losses(label, losses):
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"{label}: losses {losses}")


def resumed_state_check(resumed_at):
    """The callback of (a)'s resumed run: right after the load, the
    parameters and statistics, the momentum buffers and the groups' lr equal
    the checkpoint's bit for bit, and the lr is the schedule's at the
    restored step."""
    from rubiksnet_torch.train import lr_schedule

    def check(model, optimizer, scheduler, path):
        saved = torch.load(path, map_location="cpu", weights_only=True)
        state = model.state_dict()
        bad = [k for k, v in saved["model"].items()
               if not torch.equal(state[k].cpu(), v)]
        got_opt = optimizer.state_dict()
        bad += [f"momentum {k}" for k, v in saved["optimizer"]["state"].items()
                if not torch.equal(got_opt["state"][k]["momentum_buffer"].cpu(),
                                   v["momentum_buffer"])]
        lrs = [g["lr"] for g in optimizer.param_groups]
        want_lr = [g["lr"] for g in saved["optimizer"]["param_groups"]]
        fn = lr_schedule("cosine", 1e-3, 2, 8)
        step = saved["step"]
        sched_lr = [fn(step), fn(step), fn(step) * 0.1]
        ok = not bad and lrs == want_lr == sched_lr and (
            scheduler.last_epoch == step)
        print(f"  (a) resumed from {path.split('/')[-1]} (step {step}): "
              f"parameters, statistics and momentum buffers bit-identical "
              f"to the checkpoint, lr {lrs} = the checkpoint's = the "
              f"schedule's at step {step} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"resumed state differs from the checkpoint: {bad[:4]}, "
                 f"lr {lrs} vs {want_lr} vs {sched_lr}")
        resumed_at.append(step)

    return check


def se_edge_check(dev, cpu_gen, gen):
    """The SE rule of fused_*_supported at its edge on the card: where it
    declines, the C side refuses the launch (invalid argument); one step
    inside, the kernel runs and agrees with its plain version (bf16). K2's
    plan makes room for the gate at every max_shift it takes, so K2 runs at
    5 and at 7 (its widest tap window), on two plans."""
    from rubiksnet_torch.ops.fused_block import (
        fold_blocks,
        fused_block_kernel,
        fused_block_plain,
        fused_block_supported,
        stack_se_params,
    )
    from rubiksnet_torch.ops.fused_entry import (
        fused_entry_kernel,
        fused_entry_plain,
        fused_entry_supported,
        stack_entry_params,
    )

    bf = torch.bfloat16
    # K2's plan makes room for the gate at every max_shift it takes: at 7
    # with fewer rows a stage than at 5.
    for ms, runs in ((5, True), (7, True)):
        shape = (8, FRAMES, 14, 14, 288)
        blocks = [random_block(288, 288, 1, False, cpu_gen, dev, use_se=True)
                  for _ in range(2)]
        vt, wm, se = fold_blocks(blocks, bf, ms, se=True)
        x = randn(shape, bf, gen, dev)
        edge("K2-SE", shape, ms, fused_block_supported(shape, ms, bf,
                                                       se=True), runs,
             lambda: fused_block_kernel(x, vt, wm, se, max_shift=ms),
             lambda: fused_block_plain(x, vt, wm, se, max_shift=ms))
    for ms, runs in ((1, True), (2, False)):
        shape = (2, FRAMES, 14, 14, 288)
        blk = random_block(288, 576, 2, False, cpu_gen, dev, use_se=True)
        params = stack_entry_params(blk, bf, ms)
        se = stack_se_params([blk])[0]
        x = randn(shape, bf, gen, dev)
        edge("K3-SE", shape, ms, fused_entry_supported(
            shape, 288, 576, ms, bf, se=True), runs,
             lambda: fused_entry_kernel(x, params, se, max_shift=ms),
             lambda: fused_entry_plain(x, params, se, max_shift=ms))


def edge(label, shape, ms, supported, runs, kernel, plain):
    text = f"(e) {label} bf16 {shape} max_shift {ms}: supported {supported}"
    if supported != runs:
        fail(f"{text}: expected supported={runs}")
    if runs:
        judge(text + ", kernel vs plain", kernel(), plain(), torch.bfloat16,
              [])
        return
    try:
        kernel()
    except RuntimeError as exc:
        if "invalid argument" not in str(exc):
            raise
        print(f"  {text}, the C side refuses it ({exc}) ok")
    else:
        fail(f"{text}: the kernel ran where the rule declines it")
    torch.cuda.synchronize()


def route_check(dev, gen):
    """(e) Large bf16 at ROUTE_SIZE px: the executor runs the last entry
    (7 x 7) on the module path (K1 once, at stride 2), every other block on
    K2 and K3, and agrees with the plain model."""
    from rubiksnet_torch.models.fused_infer import FusedExecutor

    model = build_models("large", "rubiks3d", dev)[torch.bfloat16]
    video = torch.randn((BATCH_CHECK, FRAMES, ROUTE_SIZE, ROUTE_SIZE, 3),
                        generator=gen, device=dev)
    executor = FusedExecutor(model)
    with torch.no_grad():
        ref = model(video, plain=True)
        got, counts = counted(lambda: executor(video))
    steps = executor.route(video.shape, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    modules = [n for k, ns, _ in steps if k == "module" for n in ns]
    _, _, rel = errors(got, ref)
    want = dict.fromkeys(counts, 0)
    want.update(fused_block=47, fused_entry=3, shift3d=1, stem_conv=1)
    want = k2_ring(want)
    ok = (rel <= TOL_MODEL_BF16 and modules == ["layer4_0"]
          and counts == want and bool(torch.isfinite(got.float()).all()))
    print(f"  (e) Large bf16 {BATCH_CHECK}x{FRAMES}x{ROUTE_SIZE}x{ROUTE_SIZE}"
          f" through the executor: module path {modules}, launches {counts}, "
          f"logits vs plain model rel_l2={rel:.3e} [<= {TOL_MODEL_BF16}] "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the executor's per-shape route at 112 px failed")


def small_default_route(dev, gen):
    """(e) Small bf16 at create_rubiksnet's default max_shift (4), 224 px,
    batch 1, 8 and 32 through the executor: the steps whose SE gate does not
    fit K2's or K3's launch A (FusedExecutor.declined) run on the module
    path, the launches follow the route, and the logits agree with the
    plain model."""
    from rubiksnet_torch.models.fused_infer import FusedExecutor
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet

    model = randomize_bn(create_rubiksnet(
        "small", CLASSES, FRAMES, dtype=torch.bfloat16, device="cpu",
        generator=torch.Generator().manual_seed(0)),
        torch.Generator().manual_seed(1)).to(dev)
    executor = FusedExecutor(model)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for batch in (1, 8, 32):
        video = torch.randn((batch, FRAMES, SIZE, SIZE, 3), generator=gen,
                            device=dev)
        with torch.no_grad():
            ref = model(video, plain=True)
            got, counts = counted(lambda: executor(video))
        steps = executor.route(video.shape, sms)
        declined = executor.declined[(tuple(video.shape), sms)]
        blocks = sum(len(ns) for k, ns, _ in steps if k == "block")
        entries = sum(1 for k, _, _ in steps if k == "entry")
        want = dict.fromkeys(counts, 0)
        want.update(fused_block=blocks, fused_entry=entries,
                    se_gate=blocks + entries, stem_conv=1,
                    shift3d=sum(1 for k, _, _ in steps if k == "module"))
        want = k2_ring(want)
        _, _, rel = errors(got, ref)
        ok = (rel <= TOL_MODEL_BF16 and counts == want
              and bool(torch.isfinite(got.float()).all()))
        print(f"  (e) Small bf16 max_shift {model.max_shift} {batch}x{FRAMES}"
              f"x{SIZE}x{SIZE}: declined {declined}, launches {counts}, "
              f"logits vs plain model rel_l2={rel:.3e} [<= "
              f"{TOL_MODEL_BF16}] {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"Small at the default max_shift, batch {batch}, failed")
    del model, executor
    torch.cuda.empty_cache()


def train_script_phase(dev, gen, cpu_gen, name, smi):
    """Phase 9: the training entry points as a user runs them, on the card:
    ``rubiksnet_torch.scripts.train`` (synthetic, then resumed; registry),
    ``test_models`` on its final weights, ``example_finetune``; then the
    executor's route at 112 px, Small's at the default max_shift, and the
    SE rule's edge."""
    import tempfile

    from rubiksnet_torch.models import load_pretrained
    from rubiksnet_torch.scripts import eval_throughput, example_finetune
    from rubiksnet_torch.scripts import test_models
    from rubiksnet_torch.scripts import train as train_script

    bs = TRAIN_SCRIPT_BATCH
    common = ["--tier", "large", "--batch-size", str(bs), "--log-every",
              "1", "--num-classes", str(CLASSES), "--frames", str(FRAMES),
              "--input-size", str(SIZE)]
    print(f"[train script] RubiksNet-Large float32, {FRAMES}x{SIZE}x{SIZE}, "
          f"batch {bs} ({name}, {smi})")
    with tempfile.TemporaryDirectory(prefix="rubiks_train_") as root:
        # (a) synthetic, cosine schedule, checkpoints, validation; resume.
        ckpt = f"{root}/synthetic"
        argv = ["--synthetic", "48", *common, "--steps",
                str(TRAIN_SCRIPT_STEPS), "--lr-schedule", "cosine",
                "--warmup-steps", "2", "--total-steps", "8", "--save-every",
                "2", "--val-every", "4", "--val-size", "8",
                "--checkpoint-dir", ckpt]
        args = train_script.build_parser().parse_args(argv)
        first, counts = counted(lambda: train_script.train(args))
        label = "(a) synthetic 48 clips, --steps 4, cosine"
        finite_losses(label, first["losses"])
        check_train_launches(label, counts, len(first["losses"]),
                             first["val_batches"])
        run_stats(label, first["step_s"], first["wait_s"], bs,
                  first["peak_memory_bytes"], name, smi)
        del first
        resumed_at = []
        args = train_script.build_parser().parse_args(
            argv[:argv.index("--steps")] + [
                "--steps", str(TRAIN_SCRIPT_RESUME)]
            + argv[argv.index("--steps") + 2:] + ["--resume"])
        second, counts = counted(lambda: train_script.train(
            args, after_resume=resumed_state_check(resumed_at)))
        label = "(a) --resume --steps 2"
        finite_losses(label, second["losses"])
        check_train_launches(label, counts, len(second["losses"]),
                             second["val_batches"])
        ok = (resumed_at == [TRAIN_SCRIPT_STEPS]
              and second["global_step"]
              == TRAIN_SCRIPT_STEPS + TRAIN_SCRIPT_RESUME)
        print(f"  {label}: resumed at step {resumed_at}, global step "
              f"{second['global_step']} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the resumed run did not continue the global step")
        run_stats(label, second["step_s"], second["wait_s"], bs,
                  second["peak_memory_bytes"], name, smi)
        del second
        torch.cuda.empty_cache()

        # (b) the registry path: somethingv2 over synthetic SSv2-like videos.
        t0 = time.perf_counter()
        data = eval_throughput.generate_registry(
            f"{root}/data", REGISTRY_TRAIN, REGISTRY_VAL, CLASSES, seed=0)
        print(f"  wrote {REGISTRY_TRAIN} + {REGISTRY_VAL} videos in the "
              f"somethingv2 layout in {time.perf_counter() - t0:.1f} s")
        args = train_script.build_parser().parse_args(
            ["somethingv2", "--root", data, *common, "--steps",
             str(REGISTRY_TRAIN // bs), "--checkpoint-dir",
             f"{root}/registry"])
        reg, counts = counted(lambda: train_script.train(args))
        label = f"(b) registry, {REGISTRY_TRAIN} videos, PIL decode"
        finite_losses(label, reg["losses"])
        check_train_launches(label, counts, len(reg["losses"]),
                             reg["val_batches"])
        run_stats(label, reg["step_s"], reg["wait_s"], bs,
                  reg["peak_memory_bytes"], name, smi)
        step_alone(reg["model"], reg["step_s"], bs, dev, gen, name, smi)
        final = reg["final_path"]
        del reg
        torch.cuda.empty_cache()

        # (c) the evaluator on (b)'s final weights, 1-clip, bf16.
        for h, c, _ in BLOCK_SHAPES:
            checked_plan((bs, FRAMES, h, h, c), False, False, dev)
        for h, cin, cm in ENTRY_SHAPES:
            checked_entry_plan((bs, FRAMES, h, h, cin), cm, False, dev)
        args = test_models.build_parser().parse_args(
            ["somethingv2", "-p", final, "--root-path", data,
             "--batch-size", str(bs), "--frames", str(FRAMES), "--dtype",
             "bfloat16", "--loader", "pil"])
        result, counts = counted(lambda: test_models.evaluate(
            args, log=lambda *a: None))
        st, batches = result["stats"], result["batches"]
        want = dict.fromkeys(counts, 0)
        want.update(fused_block=47 * batches, fused_entry=4 * batches,
                    stem_conv=batches)
        want = k2_ring(want)
        ok = (counts == want and result["logits"].shape
              == (REGISTRY_VAL, CLASSES))
        print(f"  (c) test_models on model_final.pth.tar, 1-clip, bf16: "
              f"{st['videos']} videos, {batches} batches, launches {counts},"
              f" top1 {result['top1']:.2f}%, {st['sec_per_video']:.5f} "
              f"s/video, host-wait share {st['host_wait_frac']:.3f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the evaluator on the trained weights failed")
        plain = load_pretrained(final, device=dev, dtype=torch.bfloat16)
        first_batch_vs_plain("(c) 1-clip", args, result, bs, 1, plain, dev)
        del plain
        torch.cuda.empty_cache()

    # (d) example_finetune.
    out, counts = counted(lambda: example_finetune.main(
        ["--tier", "large", "--train-size", "16", "--test-size", "8",
         "--total-epochs", "1", "--batch-size", str(bs), "--frames",
         str(FRAMES), "--input-size", str(SIZE), "--device", "cuda"],
        log=lambda *a: None))
    label = "(d) example_finetune, 16 + 8 clips"
    finite_losses(label, out["losses"])
    check_train_launches(label, counts, len(out["losses"]), 1)
    run_stats(label, out["step_s"], out["wait_s"], bs,
              out["peak_memory_bytes"], name, smi)
    del out
    torch.cuda.empty_cache()

    # (e) the executor's route per shape, and the SE rule's edge.
    route_check(dev, gen)
    small_default_route(dev, gen)
    se_edge_check(dev, cpu_gen, gen)


def train_config(label, tier, variant, want, dev, gen, name, smi):
    """One bf16 train step of a configuration at batch TIME_BATCH, counted
    (its main path), then its throughput at that batch."""
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet
    from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult

    model = create_rubiksnet(tier, CLASSES, FRAMES, variant,
                             max_shift=MAX_SHIFT, device=dev,
                             dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0))
    model.train()
    step = make_train_step(model, sgd_with_shift_mult(model, 0.01, 0.1))
    video = torch.randn((TIME_BATCH, FRAMES, SIZE, SIZE, 3), generator=gen,
                        device=dev)
    labels = torch.randint(0, CLASSES, (TIME_BATCH,), generator=gen,
                           device=dev)
    metrics, launches = counted(lambda: step(video, labels))
    loss = float(metrics["loss"])
    print(f"[train] launches of one {label} bf16 train step, batch "
          f"{TIME_BATCH}: {launches}; loss {loss:.4f}")
    zero = dict.fromkeys(launches, 0)
    if launches != dict(zero, **want):
        fail(f"{label} train step launches {launches} != {want}")
    if not math.isfinite(loss):
        fail(f"{label} train step loss is not finite")
    for n, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            fail(f"{label} train step: bad gradient of {n}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = sorted(cuda_call_times_ms(lambda: step(video, labels),
                                   iters=TRAIN_ITERS, warmup=TRAIN_WARMUP))
    med = ms[len(ms) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {label} kernels batch {TIME_BATCH}: median {med:.3f} ms/step "
          f"(min {ms[0]:.3f}, max {ms[-1]:.3f}, n={len(ms)}), "
          f"{TIME_BATCH * 1000.0 / med:.1f} clips/s, peak memory "
          f"{peak:.2f} GiB ({name}, {smi})")
    return launches


# Phase 10: serving export. Programs of the eval forward
# (rubiksnet_torch.serving.export_eval_fn, torch.export) in bf16 at
# 8x224x224, 1 crop: (label, tier, variant, fused, symbolic batch, batches
# run, launches of one run, {kernels-line row: counter}).
EXPORT_CASES = (
    ("Large fused, batch 8", "large", "rubiks3d", True, False, (8,),
     {"fused_block": 47, "fused_entry": 4, "stem_conv": 1},
     {"fused_block": "fused_block", "fused_entry": "fused_entry",
      "stem_conv": "stem_conv"}),
    ("Large fused, batch n in [1, 32]", "large", "rubiks3d", True, True,
     SERVE_BATCHES, {"fused_block": 47, "fused_entry": 4, "stem_conv": 1},
     {}),
    ("Large module path, batch 8", "large", "rubiks3d", False, False, (8,),
     {"shift3d": 51}, {"shift3d": "shift3d"}),
    ("Large-AQ fused, batch 8", "large", "rubiks3d-aq", True, False, (8,),
     {"fused_block": 47, "fused_entry_aq": 4, "stem_conv": 1},
     {"fused_block_aq": "fused_block", "fused_entry_aq": "fused_entry_aq"}),
    ("Small fused, batch 8", "small", "rubiks3d", True, False, (8,),
     {"fused_block": 13, "fused_entry": 4, "se_gate": 17, "stem_conv": 1},
     {"fused_block_se": "fused_block", "fused_entry_se": "fused_entry",
      "se_gate": "se_gate"}),
)
EXPORT_MAX_BATCH = max(SERVE_BATCHES)
# The program against the live route it was traced from: equal (the same
# kernels under the same plans on the same input), or else within this
# relative L2, said on its line.
TOL_EXPORT_LIVE = 1e-3

# The process that serves the saved programs: it imports
# rubiksnet_torch.serving (and the ops' launch counters), builds no model,
# and runs each program at each of its batches on a video drawn from the
# same seed as the parent's, the launches of each run counted.
SERVE_PROGRAMS = r"""
import json, sys, torch
from rubiksnet_torch.serving import load_exported, run_exported
from rubiksnet_torch.ops import launch_counters
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
root, jobs = sys.argv[1], json.loads(sys.argv[2])
counters, out = launch_counters(), {}
for name, shapes in jobs.items():
    program = load_exported(f"{root}/{name}.pt2")
    for seed, shape in shapes:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        video = torch.randn(shape, generator=gen, device="cuda")
        for c in counters.values():
            c.reset()
        logits = run_exported(program, video)
        torch.cuda.synchronize()
        out[f"{name}/{seed}"] = (logits.cpu(),
                                 {k: c.count for k, c in counters.items()})
torch.save(out, f"{root}/served.pt")
"""


def export_video(batch, seed, dev):
    """The (batch, 1, T, H, W, 3) video of seed ``seed`` on the card; the
    serving process draws the same one."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, 1, FRAMES, SIZE, SIZE, 3), generator=gen,
                       device=dev)


def check_batch_range(errs, gen, cpu_gen, dev, hi, aq, se):
    """K2 and K3 in bf16 at every shape of the fused route at every batch
    1..hi that phase 1 did not check, against the plain version (each run
    twice, bit-identically), as phase 1 checks its batches: a program
    traced at a symbolic batch launches at each batch the plan the kernel's
    wrapper picks there, so each of those plans is held first."""
    from rubiksnet_torch.utils import fused_block_probe as block_probe
    from rubiksnet_torch.utils import fused_entry_probe as entry_probe

    bf = torch.bfloat16
    batches = range(1, hi + 1)
    checked, plans, worst = 0, set(), {}
    for label, n, t, h, w, c, k, kind, blocks in block_probe.served_cases(
            batches):
        if ((n, t, h, w, c), aq, se) in CHECKED_PLANS:
            continue
        ok, max_abs, text, plan = block_probe.check_case(
            label, (n, t, h, w, c), k, kind, blocks, aq, se, bf, gen,
            cpu_gen, dev, gate_errs=errs["se_gate"])
        if not ok:
            fail(f"K2 {text}")
        CHECKED_PLANS[(n, t, h, w, c), aq, se] = plan
        for kd in block_kinds(aq, se):
            errs[kd].append(max_abs)
        checked += 1
        plans.add(("K2", h, plan.describe()))
        worst["K2"] = max(worst.get("K2", 0.0), max_abs)
    for label, n, t, h, w, cin, cm, k, kind in entry_probe.served_cases(
            batches):
        if ((n, t, h, w, cin), cm, se, aq) in CHECKED_ENTRY_PLANS:
            continue
        ok, max_abs, text, plan = entry_probe.check_case(
            label, (n, t, h, w, cin), cm, k, kind, se, bf, gen, cpu_gen,
            dev, gate_errs=errs["se_gate"], aq=aq)
        if not ok:
            fail(f"K3 {text}")
        CHECKED_ENTRY_PLANS[(n, t, h, w, cin), cm, se, aq] = plan
        errs[entry_kind(se, aq)].append(max_abs)
        checked += 1
        plans.add(("K3", h, plan.describe()))
        worst["K3"] = max(worst.get("K3", 0.0), max_abs)
    print(f"  K2 and K3 bf16 (aq={aq}, se={se}) at every "
          f"batch 1..{hi}: {checked} shapes not checked before, now held "
          f"against plain, bit-identical on a rerun, {len(plans)} distinct "
          f"(shape, plan) pairs among them; worst max_abs "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


def export_phase(dev, gen, cpu_gen, errs, name, smi):
    """(a)-(c): export each case of EXPORT_CASES, save it, load and run it
    in a fresh process, and hold its launches and logits there against the
    live route (the FusedExecutor, or the module path) and the plain model
    on the same video; (d) the exported Large programs timed beside the
    live executor. A symbolic-batch case first holds K2's and K3's plans at
    every batch of its range against the plain version
    (:func:`check_batch_range`). Returns {kernels-line row: launches of the
    program}."""
    import subprocess
    import tempfile
    from pathlib import Path

    from rubiksnet_torch.models import FusedExecutor, create_rubiksnet
    from rubiksnet_torch.serving import (
        export_eval_fn,
        load_exported,
        operator_counts,
        run_exported,
        save_exported,
    )

    t_phase = time.perf_counter()
    bf = torch.bfloat16
    print(f"[export] serving programs, bf16, {FRAMES}x{SIZE}x{SIZE}, 1 crop, "
          f"random weights (seed 0, BN statistics seed 1), max_shift "
          f"{MAX_SHIFT}, {name} ({smi})")
    built, live, jobs, rows, timed_programs = None, {}, {}, {}, []
    with tempfile.TemporaryDirectory(prefix="rubiks_serving_") as root:
        for i, (label, tier, variant, fused, poly, batches, want,
                _) in enumerate(EXPORT_CASES):
            aq, se = variant == "rubiks3d-aq", tier == "small"
            if built != (tier, variant):
                model = randomize_bn(create_rubiksnet(
                    tier, CLASSES, FRAMES, variant, max_shift=MAX_SHIFT,
                    dtype=bf, device="cpu",
                    generator=torch.Generator().manual_seed(0)),
                    torch.Generator().manual_seed(1)).to(dev)
                built = (tier, variant)
            if fused and poly:
                check_batch_range(errs, gen, cpu_gen, dev, EXPORT_MAX_BATCH,
                                  aq, se)
            if fused:
                for bs in (range(1, EXPORT_MAX_BATCH + 1) if poly
                           else batches):
                    for h, c, _ in BLOCK_SHAPES:
                        checked_plan((bs, FRAMES, h, h, c), aq, se, dev)
                    for h, cin, cm in ENTRY_SHAPES:
                        checked_entry_plan((bs, FRAMES, h, h, cin), cm, se,
                                           dev, aq)
            t0 = time.perf_counter()
            program = export_eval_fn(model, batches[0], num_crops=1,
                                     input_size=SIZE, fused=fused,
                                     polymorphic_batch=poly,
                                     max_batch=EXPORT_MAX_BATCH)
            t_export = time.perf_counter() - t0
            path = Path(root) / f"case{i}.pt2"
            save_exported(str(path), program)
            ops = {k: v for k, v in sorted(operator_counts(program).items())
                   if k.startswith("rubiksnet.")}
            print(f"  ({label}) exported in {t_export:.2f} s, saved "
                  f"{path.stat().st_size / 1e6:.1f} MB; operators {ops}")
            if operator_counts(program)["aten.gather"]:
                fail(f"export {label}: the plain shift's gather is in the "
                     f"graph")
            executor = FusedExecutor(model) if fused else None
            jobs[f"case{i}"] = []
            with torch.no_grad():
                for bs in batches:
                    seed = 1000 + 100 * i + bs
                    video = export_video(bs, seed, dev)
                    flat = video.reshape((bs,) + tuple(video.shape[2:]))
                    live[i, bs] = (
                        (executor(flat) if fused else model(flat)).float(),
                        model(flat, plain=True).float())
                    jobs[f"case{i}"].append(
                        (seed, list(video.shape)))
            if label.startswith("Large fused"):
                # (d) kept loaded here, to time beside the live executor.
                timed_programs.append((label, load_exported(str(path)),
                                       executor, batches))
            del program
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", SERVE_PROGRAMS, root, json.dumps(jobs)],
            cwd=str(Path(__file__).resolve().parent), capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            fail(f"serving process failed ({proc.returncode}):\n"
                 f"{proc.stderr[-4000:]}")
        served = torch.load(Path(root) / "served.pt")
        print(f"  serving process (imports rubiksnet_torch.serving, builds "
              f"no model): loaded and ran {len(jobs)} programs in "
              f"{time.perf_counter() - t0:.1f} s")
    zero = dict.fromkeys(LAUNCH_COUNTERS, 0)
    for i, (label, _, _, fused, _, batches, want, row_of) in enumerate(
            EXPORT_CASES):
        for bs in batches:
            logits, counts = served[f"case{i}/{1000 + 100 * i + bs}"]
            got = logits.to(dev).float()
            ref_live, ref_plain = live[i, bs]
            if counts != k2_ring(dict(zero, **want)):
                fail(f"export {label} batch {bs}: launches {counts} != "
                     f"{want}")
            if got.shape != (bs, CLASSES) or not torch.isfinite(got).all():
                fail(f"export {label} batch {bs}: bad logits "
                     f"{tuple(got.shape)}")
            same = torch.equal(got, ref_live)
            _, _, to_live = errors(got, ref_live)
            _, _, to_plain = errors(got, ref_plain)
            route = "executor" if fused else "module path"
            print(f"  ({label}) batch {bs}: launches "
                  f"{ {k: v for k, v in counts.items() if v} }; vs the live "
                  f"{route}: "
                  + ("bit-identical" if same else
                     f"rel_l2={to_live:.3e} [<= {TOL_EXPORT_LIVE}], not "
                     f"bit-identical: the program's aten ops around the "
                     f"kernels (stem conv, head) may take other library "
                     f"kernels than eager code")
                  + f"; vs plain model rel_l2={to_plain:.3e} [<= "
                    f"{TOL_MODEL_BF16}]")
            if not same and to_live > TOL_EXPORT_LIVE:
                fail(f"export {label} batch {bs}: program and live "
                     f"{route} disagree")
            if to_plain > TOL_MODEL_BF16:
                fail(f"export {label} batch {bs}: program and plain model "
                     f"disagree")
            rows.update({k: counts[c] for k, c in row_of.items()})
    # (d) Timing, as serve_phase times: CUDA events around each call,
    # SERVE_ITERS calls after 2 warm-ups, in this process.
    print(f"[export] timing: the exported Large programs beside the live "
          f"executor, bf16, {FRAMES}x{SIZE}x{SIZE}, {name} ({smi})")

    def timed(what, fn, bs):
        ms = sorted(cuda_call_times_ms(fn, iters=SERVE_ITERS, warmup=2))
        med = ms[len(ms) // 2]
        print(f"  {what} batch {bs}: median {med:.3f} ms/batch (min "
              f"{ms[0]:.3f}, max {ms[-1]:.3f}, n={len(ms)}), "
              f"{bs * 1000.0 / med:.1f} clips/s ({name}, {smi})")

    with torch.no_grad():
        for label, program, executor, batches in timed_programs:
            for bs in batches:
                video = export_video(bs, 7 + bs, dev)
                flat = video.reshape((bs,) + tuple(video.shape[2:]))
                timed("live executor", lambda: executor(flat), bs)
                timed(f"program ({label})",
                      lambda: run_exported(program, video), bs)
    print(f"[export] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return rows


# Phase 11: parallelism. Two ranks on the one card (gloo: they share it),
# spawned from the script, then one NCCL rank at world size 1. (a) the DDP
# train step, Large f32 8x224x224, two ranks at local batch 4 against one
# process at batch 8 from one state (the tolerances of the Large f32 step
# above); (b) time-sharded eval, Large and Large-AQ bf16 at batch 8, T = 8
# over 2 shards, against the unsharded module path; (c) the temporal shift
# op (halo, K1, K1-inverse, K4) at Large's five stage shapes against the
# unsharded kernels; (d) test_models with the batch sharded, 16 videos,
# against one process.
PARALLEL_RANKS = 2
PARALLEL_TIMED = 3  # timed steps or batches after one warm-up
# (d): the ranks' global batch of 16 is 8 a rank, the one process's batch,
# so each K2 and K3 launch sees the same clips at a checked plan.
# Ten classes, so that random weights hit some labels (top-1 near 10%,
# top-5 near 50%) and the accuracies compared are not all zero.
PARALLEL_VIDEOS, PARALLEL_EVAL_BATCH, PARALLEL_CLASSES = 16, 16, 10
PARALLEL_TIMEOUT_S = 600


def shift_inputs(batch, frames):
    """(shape, stride) of each of Large's 51 3D shift inputs, forward
    order aside: its stride-1 blocks and the mid tensors of its entries."""
    calls = [((batch, frames, h, h, c), 1) for h, c, n in BLOCK_SHAPES
             for _ in range(n)]
    return calls + [((batch, frames, h, h, cm), 2)
                    for h, _, cm in ENTRY_SHAPES]


def large_train_model(dev):
    """Large f32 from seed 0, BN statistics randomized (seed 1), train
    mode: phase 11 (a)'s state, alike in every process."""
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet

    m = create_rubiksnet("large", CLASSES, FRAMES, "rubiks3d",
                         max_shift=MAX_SHIFT, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return randomize_bn(m, torch.Generator().manual_seed(1)).to(dev).train()


def parallel_batch(dev, seed):
    """(8, 8, 224, 224, 3) clips and labels from a CPU seed, alike in every
    process."""
    g = torch.Generator().manual_seed(seed)
    video = torch.randn((TIME_BATCH, FRAMES, SIZE, SIZE, 3), generator=g)
    labels = torch.randint(0, CLASSES, (TIME_BATCH,), generator=g)
    return video.to(dev), labels.to(dev)


def wall_ms(fn, timed=PARALLEL_TIMED):
    """Host milliseconds of each of ``timed`` calls of ``fn()`` after one
    warm-up, each ended by a device synchronize (every rank calls it
    alike: the calls hold collectives)."""
    out = []
    for i in range(timed + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)


def step_state(model, metrics):
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    stats = {n: b.detach().cpu() for n, b in model.named_buffers()
             if not n.endswith("num_batches_tracked")}
    return float(metrics["loss"]), grads, stats


def job_temporal_op(rank, group, spec, dev):
    """(c) The temporal shift at Large's five stage shapes, f32 and bf16,
    fractional and quantized (a third of the T shifts in (K + 0.5, K + 1],
    a third in [-K - 1, -K - 0.5), +-(K + 1) among them): forward, input gradient and raw shift
    gradient of the sharded op against the unsharded kernels on the whole
    clip (every rank draws the same clip)."""
    from rubiksnet_torch.ops import shift3d as s3
    from rubiksnet_torch.parallel import (
        temporal_rubiks_shift_3d, time_shard_clip,
    )

    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []
    for h, c, _ in BLOCK_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for q in (False, True):
                x = randn((BATCH_CHECK, FRAMES, h, h, c), dt, gen, dev)
                og = randn(x.shape, dt, gen, dev)
                shift = torch.rand((3, c), generator=gen, device=dev) * 2 - 1
                if q:
                    third = c // 3
                    far = torch.rand((2, third), generator=gen, device=dev)
                    shift[0, :third] = MAX_SHIFT + 0.51 + 0.49 * far[0]
                    shift[0, third:2 * third] = -(MAX_SHIFT + 0.51
                                                  + 0.49 * far[1])
                    shift[0, 0], shift[0, third] = (MAX_SHIFT + 1,
                                                    -MAX_SHIFT - 1)
                y = s3.shift3d_kernel(x, shift, 1, 0, q)
                gx = s3.shift3d_input_grad_kernel(og, shift, x.shape, 1, 0,
                                                  q)
                gs = s3.shift3d_shift_grad_kernel(og, x, shift, 1, 0)
                xl = time_shard_clip(x, group).requires_grad_()
                sl = shift.clone().requires_grad_()
                yl = temporal_rubiks_shift_3d(xl, sl, group, 1,
                                              normalize_grad=False,
                                              quantize=q,
                                              max_shift=MAX_SHIFT)
                yl.backward(time_shard_clip(og, group))
                mine = slice(rank * FRAMES // PARALLEL_RANKS,
                             (rank + 1) * FRAMES // PARALLEL_RANKS)
                label = (f"{h}x{h}x{c} {str(dt)[6:]} "
                         f"{'quantize' if q else 'fractional'}")
                rows.append((label, torch.equal(yl.detach(), y[:, mine]),
                             errors(yl.detach(), y[:, mine]),
                             errors(xl.grad, gx[:, mine]),
                             errors(sl.grad, gs)))
    return rows


def job_ddp(rank, group, spec, dev):
    """(a) One DDP train step at local batch 4, counted, then timed."""
    from rubiksnet_torch.parallel import shard_batch
    from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult

    model = large_train_model(dev)
    step = make_train_step(model, sgd_with_shift_mult(model, 0.01),
                           data_group=group)
    video, labels = shard_batch(parallel_batch(dev, 2), group)
    metrics, counts = counted(lambda: step(video, labels))
    loss, grads, stats = step_state(model, metrics)
    out = dict(loss=loss, counts=counts,
               ms=wall_ms(lambda: step(video, labels)))
    if rank == 0:
        out.update(grads=grads, stats=stats)
    return out


def job_sequence_eval(rank, group, spec, dev):
    """(b) Large and Large-AQ bf16 at batch 8 with T over the ranks, on the
    module path: logits and launches of one batch, then timed; and the
    halo exchanges (all-reduce) of one forward alone."""
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet
    from rubiksnet_torch.parallel import (
        sequence_parallel_eval, time_shard_clip,
    )
    from rubiksnet_torch.parallel.temporal import _exchange, halo_width

    out = {}
    video = time_shard_clip(parallel_batch(dev, 3)[0], group)
    for variant in ("rubiks3d", "rubiks3d-aq"):
        model = create_rubiksnet("large", CLASSES, FRAMES, variant,
                                 max_shift=MAX_SHIFT, device=dev,
                                 dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(0))
        fn = sequence_parallel_eval(model, group)
        logits, counts = counted(lambda: fn(video))
        out[variant] = dict(logits=logits.float().cpu(), counts=counts,
                            ms=wall_ms(lambda: fn(video)))
        del model, fn
    k = halo_width(MAX_SHIFT)
    blocks = [torch.zeros(shape, dtype=torch.bfloat16, device=dev)
              for shape, _ in shift_inputs(TIME_BATCH,
                                           FRAMES // PARALLEL_RANKS)]
    out["exchange_ms"] = wall_ms(lambda: [_exchange(b, k, group)
                                          for b in blocks])
    return out


def job_test_models(rank, group, spec, dev):
    """(d) The evaluator with the batch sharded, counted."""
    from rubiksnet_torch.scripts import test_models

    args = test_models.build_parser().parse_args(spec["eval_argv"])
    result, counts = counted(lambda: test_models.evaluate(
        args, log=lambda *a: None))
    return dict(counts=counts, batches=result["batches"],
                **{k: result[k] for k in ("logits", "labels", "top1", "top5",
                                          "class_accuracy")})


def job_nccl_step(rank, group, spec, dev):
    """One DDP train step of the tiny model (TINY's shapes) on the NCCL
    group of one rank, counted."""
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet
    from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult

    model = create_rubiksnet("tiny", TINY["classes"], TINY["frames"],
                             max_shift=MAX_SHIFT, device=dev,
                             generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, sgd_with_shift_mult(model, 0.05),
                           data_group=group)
    g = torch.Generator(device=dev).manual_seed(4)
    video = torch.randn((TINY["batch"], TINY["frames"], TINY["size"],
                         TINY["size"], 3), generator=g, device=dev)
    labels = torch.arange(TINY["batch"], device=dev) % TINY["classes"]
    metrics, counts = counted(lambda: step(video, labels))
    return dict(loss=float(metrics["loss"]), counts=counts)




def parallel_rank(rank, world, store, out, spec):
    """One spawned rank of phase 11: joins the group (the backend by
    ``initialize_distributed``'s rule), runs ``spec["jobs"]`` on the card
    and saves what they return."""
    import torch.distributed as dist

    from rubiksnet_torch.ops import _build
    from rubiksnet_torch.parallel import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(
        init_method=f"file://{store}", world_size=world, rank=rank,
        device="cuda",
        log=lambda m: print(f"  [rank {rank}] {m}", flush=True))
    dev = torch.device("cuda", torch.cuda.current_device())
    group = dist.group.WORLD
    _build.load_library()
    result = {"backend": dist.get_backend(group)}
    for job in spec["jobs"]:
        result[job] = PARALLEL_JOBS[job](rank, group, spec, dev)
        torch.cuda.empty_cache()
    torch.save(result, f"{out}/rank{rank}.pt")
    dist.destroy_process_group()


# A rank's process: this script imported as a module, one call of
# parallel_rank(rank, world, store, out, spec).
RANK_MAIN = """\
import sys, torch
from chip_smoke import parallel_rank
parallel_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
              torch.load(sys.argv[5], weights_only=False))
"""


def spawn_ranks(world, spec):
    """``parallel_rank`` on ``world`` processes; their results in rank
    order. Each rank is a ``subprocess`` of this script, waited for before
    this returns, not a ``multiprocessing`` child, whose resource tracker
    would outlive the script. A rank that exits with an error fails the run
    (the others are stopped), and so do ranks still running after
    PARALLEL_TIMEOUT_S."""
    import subprocess
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(prefix="rubiks_ranks_") as tmp:
        torch.save(spec, f"{tmp}/spec.pt")
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, str(r), str(world),
             f"{tmp}/store", tmp, f"{tmp}/spec.pt"],
            cwd=str(Path(__file__).resolve().parent))
            for r in range(world)]
        deadline = time.perf_counter() + PARALLEL_TIMEOUT_S
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = [(r, c) for r, c in enumerate(codes)
                          if c not in (None, 0)]
                if failed:
                    fail(f"rank {failed[0][0]} of {world} exited with "
                         f"{failed[0][1]}")
                if all(c == 0 for c in codes):
                    break
                if time.perf_counter() > deadline:
                    fail(f"{world} ranks still running after "
                         f"{PARALLEL_TIMEOUT_S} s")
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                for r in range(world)]


def median(ms):
    return ms[len(ms) // 2]


def parallel_phase(dev, gen, name, smi):
    """Phase 11 (see its comment above). Returns each kernel's launches
    on one rank's parallel paths: the DDP step (K1, K1-inverse, K4), the
    time-sharded Large forward (K1) and a sharded evaluator batch (K2,
    K3)."""
    import tempfile

    from rubiksnet_torch.data import native_loader
    from rubiksnet_torch.models import save_pretrained
    from rubiksnet_torch.models.rubiksnet import TIERS, create_rubiksnet
    from rubiksnet_torch.parallel.temporal import halo_width
    from rubiksnet_torch.scripts import eval_throughput, test_models
    from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult

    t_phase = time.perf_counter()
    print(f"[parallel] phase 11: {PARALLEL_RANKS} ranks on one card through "
          f"gloo, then one NCCL rank; {name} ({smi}). The ranks share the "
          f"card, so the times below describe the code path, not a "
          f"multi-card run")

    # The one-process references, before the ranks take the card.
    model = large_train_model(dev)
    step = make_train_step(model, sgd_with_shift_mult(model, 0.01))
    video, labels = parallel_batch(dev, 2)
    ref_loss, ref_grads, ref_stats = step_state(model, step(video, labels))
    ref_step_ms = wall_ms(lambda: step(video, labels))
    del model, step, video, labels
    ref_eval = {}
    video = parallel_batch(dev, 3)[0]
    for variant in ("rubiks3d", "rubiks3d-aq"):
        model = create_rubiksnet("large", CLASSES, FRAMES, variant,
                                 max_shift=MAX_SHIFT, device=dev,
                                 dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            ref_eval[variant] = (model(video).float().cpu(),
                                 wall_ms(lambda: model(video)))
        del model
    # The halo's cat and slice alone, per forward (one rank's blocks).
    k = halo_width(MAX_SHIFT)
    calls = shift_inputs(TIME_BATCH, FRAMES // PARALLEL_RANKS)
    blocks = [torch.zeros(s, dtype=torch.bfloat16, device=dev)
              for s, _ in calls]
    slabs = [b[:, :k].clone() for b in blocks]
    outs = [torch.zeros((s[0], s[1] + 2 * k, (s[2] + st - 1) // st,
                         (s[3] + st - 1) // st, s[4]), dtype=torch.bfloat16,
                        device=dev) for s, st in calls]
    cat_ms = median(cuda_call_times_ms(
        lambda: [torch.cat([a, b, a], dim=1) for a, b in zip(slabs, blocks)],
        iters=5))
    trim_ms = median(cuda_call_times_ms(
        lambda: [o[:, k:o.shape[1] - k].contiguous() for o in outs],
        iters=5))
    del blocks, slabs, outs, video
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="rubiks_par_eval_") as root:
        list_file = eval_throughput.generate_frames(
            root, PARALLEL_VIDEOS, PARALLEL_CLASSES, seed=5)
        eval_model = create_rubiksnet(
            "large", PARALLEL_CLASSES, FRAMES, max_shift=MAX_SHIFT,
            device="cpu",
            generator=torch.Generator().manual_seed(0))
        ckpt = f"{root}/large.pth.tar"
        save_pretrained(randomize_bn(eval_model,
                                     torch.Generator().manual_seed(1)), ckpt)
        loader = "native" if native_loader.toolchain_present() else "pil"
        local = PARALLEL_EVAL_BATCH // PARALLEL_RANKS
        for h, c, _ in BLOCK_SHAPES:
            checked_plan((local, FRAMES, h, h, c), False, False, dev)
        for h, cin, cm in ENTRY_SHAPES:
            checked_entry_plan((local, FRAMES, h, h, cin), cm, False, dev)
        eval_argv, one_argv = (eval_throughput.evaluator_args(
            ckpt, list_file, root, PARALLEL_CLASSES, FRAMES, bs, False,
            loader=loader, prefetch=2)
            for bs in (PARALLEL_EVAL_BATCH, local))
        ref_models = test_models.evaluate(
            test_models.build_parser().parse_args(one_argv),
            log=lambda *a: None)
        torch.cuda.empty_cache()
        ranks = spawn_ranks(PARALLEL_RANKS, dict(
            jobs=["temporal_op", "ddp", "sequence_eval", "test_models"],
            eval_argv=eval_argv))

    zero = dict.fromkeys(ranks[0]["ddp"]["counts"], 0)
    print(f"[parallel] backend of the {PARALLEL_RANKS} ranks on one card: "
          f"{[r['backend'] for r in ranks]}")
    if any(r["backend"] != "gloo" for r in ranks):
        fail("ranks that share a card must take gloo")

    # (c) The temporal op.
    print(f"[parallel] (c) the temporal shift on {PARALLEL_RANKS} shards, "
          f"halo {k} frames ({halo_width(MAX_SHIFT, True)} quantized), "
          f"against the unsharded kernels (forward, input "
          f"gradient, raw shift gradient)")
    for r, res in enumerate(ranks):
        for label, same, fwd, gx, gs in res["temporal_op"]:
            dt = torch.float32 if "float32" in label else torch.bfloat16
            tol = (TOL_F32_REL_MAX, 1) if dt == torch.float32 else (
                TOL_BF16_REL_L2, 2)
            tol_gs = TOL_SHIFT_GRAD[str(dt)[6:]]
            ok = (fwd[tol[1]] <= tol[0] and gx[tol[1]] <= tol[0]
                  and gs[2] <= tol_gs)
            if r == 0 or not ok:
                print(f"  rank {r} {label}: forward "
                      f"{'bit-identical' if same else f'rel_max {fwd[1]:.2e}'}"
                      f"; input gradient rel_max {gx[1]:.2e} rel_l2 "
                      f"{gx[2]:.2e}; shift gradient rel_l2 {gs[2]:.2e} "
                      f"[{'rel_max' if tol[1] == 1 else 'rel_l2'} <= "
                      f"{tol[0]}, shift rel_l2 <= {tol_gs}] "
                      f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"(c) temporal shift {label} on rank {r} disagrees "
                     f"with the unsharded kernels")

    # (a) DDP.
    shifts = len(calls)
    n_blocks = sum(n for _, _, n in BLOCK_SHAPES)
    want = dict(zero, shift3d=shifts, shift3d_inverse=shifts,
                shift_grad=shifts)
    ddp = [r["ddp"] for r in ranks]
    for r, res in enumerate(ddp):
        print(f"[parallel] (a) rank {r}: launches of one DDP train step at "
              f"local batch {DDP_LOCAL_BATCH}: {res['counts']}")
        if res["counts"] != want:
            fail(f"DDP step launches on rank {r} {res['counts']} != {want}")
    mask = {n: g.norm(dim=0) > SHIFT_CHANNEL_FLOOR * g.norm(dim=0).max()
            for n, g in ref_grads.items() if n.endswith(".shift")}
    loss_rel = max(abs(res["loss"] - ref_loss) / abs(ref_loss)
                   for res in ddp)
    g_worst = max((errors(ddp[0]["grads"][n][:, mask[n]] if n in mask
                          else ddp[0]["grads"][n],
                          g[:, mask[n]] if n in mask else g)[2], n)
                  for n, g in ref_grads.items())
    bn_worst = max((errors(ddp[0]["stats"][n], b)[1], n)
                   for n, b in ref_stats.items())
    ok = (loss_rel <= TOL_STEP_LOSS and g_worst[0] <= TOL_STEP_GRAD_E2E
          and bn_worst[0] <= TOL_STEP_BN)
    print(f"  (a) DDP on {PARALLEL_RANKS} ranks x {DDP_LOCAL_BATCH} vs one "
          f"process x {TIME_BATCH}, Large f32: loss {ddp[0]['loss']:.6f} vs "
          f"{ref_loss:.6f} (rel {loss_rel:.3e} [<= {TOL_STEP_LOSS}]); worst "
          f"gradient rel_l2 {g_worst[0]:.3e} ({g_worst[1]}) "
          f"[<= {TOL_STEP_GRAD_E2E}]; worst BN statistic rel_max "
          f"{bn_worst[0]:.3e} ({bn_worst[1]}) [<= {TOL_STEP_BN}] "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the DDP step disagrees with the one-process step")
    print(f"[parallel] (a) train step, Large f32 {FRAMES}x{SIZE}x{SIZE}: DDP "
          f"{PARALLEL_RANKS} ranks x {DDP_LOCAL_BATCH} on one card (gloo) "
          f"median {median(ddp[0]['ms']):.1f} ms/step (rank 0, "
          f"{ddp[0]['ms']}); one process x {TIME_BATCH} median "
          f"{median(ref_step_ms):.1f} ms/step ({ref_step_ms}); host clock "
          f"around synchronized steps, {name} ({smi})")

    # (b) Time-sharded eval.
    seq = [r["sequence_eval"] for r in ranks]
    for variant, kern in (("rubiks3d", "shift3d"), ("rubiks3d-aq",
                                                    "shift2d")):
        want = dict(zero, **{kern: shifts})
        ref_logits, ref_ms = ref_eval[variant]
        for r, res in enumerate(seq):
            got = res[variant]
            same = torch.equal(got["logits"], ref_logits)
            _, rel_max, rel_l2 = errors(got["logits"], ref_logits)
            ok = (got["counts"] == want and rel_l2 <= TOL_MODEL_BF16
                  and torch.isfinite(got["logits"]).all())
            print(f"[parallel] (b) rank {r} Large {variant} bf16 batch "
                  f"{TIME_BATCH}, T {FRAMES} over {PARALLEL_RANKS} shards "
                  f"(module path): launches {got['counts']}; logits vs "
                  f"unsharded {'bit-identical' if same else 'differ'} "
                  f"(rel_max {rel_max:.3e}, rel_l2 {rel_l2:.3e} "
                  f"[<= {TOL_MODEL_BF16}]) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"(b) time-sharded {variant} on rank {r}: launches "
                     f"{got['counts']} != {want} or logits disagree")
        print(f"[parallel] (b) eval batch, Large {variant} bf16 x "
              f"{TIME_BATCH}: T over {PARALLEL_RANKS} ranks on one card "
              f"(gloo) median {median(seq[0][variant]['ms']):.1f} ms "
              f"({seq[0][variant]['ms']}); unsharded module path median "
              f"{median(ref_ms):.1f} ms ({ref_ms}); {name} ({smi})")
    print(f"[parallel] halo per forward, Large bf16 x {TIME_BATCH}, "
          f"{FRAMES // PARALLEL_RANKS} frames a shard, {k}-frame halo, "
          f"{shifts} shifts: cat {cat_ms:.3f} ms + trim {trim_ms:.3f} ms (events); "
          f"the exchanges (gloo all_reduce of the boundary slabs) median "
          f"{median(seq[0]['exchange_ms']):.1f} ms (host clock); {name} "
          f"({smi})")

    # (d) test_models with the batch sharded.
    want = k2_ring(dict(zero, fused_block=n_blocks,
                        fused_entry=len(ENTRY_SHAPES), stem_conv=1))
    for r, res in enumerate(ranks):
        got = res["test_models"]
        ok = (got["top1"] == ref_models["top1"]
              and got["top5"] == ref_models["top5"]
              and np.array_equal(got["class_accuracy"],
                                 ref_models["class_accuracy"], equal_nan=True)
              and (got["labels"] == ref_models["labels"]).all()
              and got["counts"] == {k_: v * got["batches"]
                                    for k_, v in want.items()})
        same = (got["logits"] == ref_models["logits"]).all()
        _, _, rel = errors(torch.from_numpy(got["logits"]),
                           torch.from_numpy(ref_models["logits"]))
        print(f"[parallel] (d) rank {r}: test_models over {PARALLEL_VIDEOS} "
              f"videos of {PARALLEL_CLASSES} classes, batch {PARALLEL_EVAL_BATCH} sharded ({local} a "
              f"rank): top1 {got['top1']:.2f} top5 {got['top5']:.2f} (one "
              f"process at batch {local}: {ref_models['top1']:.2f} "
              f"{ref_models['top5']:.2f}), logits "
              f"{'bit-identical' if same else f'rel_l2 {rel:.3e}'}, "
              f"launches {got['counts']} in {got['batches']} batch(es) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"(d) the sharded evaluator on rank {r} disagrees with one "
                 f"process")
    print("[parallel] gloo on CUDA tensors of one card: all_reduce and "
          "broadcast, the only collectives the port issues (halo "
          "exchanges, BN sums, shift gradients, DDP's buckets), took "
          "every call above")

    # One NCCL rank at world size 1.
    nccl = spawn_ranks(1, dict(jobs=["nccl_step"]))[0]
    tiny = 1 + sum(TIERS["tiny"][1])
    want = dict(zero, shift3d=tiny, shift3d_inverse=tiny, shift_grad=tiny)
    ok = (nccl["backend"] == "nccl" and math.isfinite(nccl["nccl_step"]["loss"])
          and nccl["nccl_step"]["counts"] == want)
    print(f"[parallel] one rank, world size 1: backend {nccl['backend']}, "
          f"DDP step of the tiny model: loss {nccl['nccl_step']['loss']:.4f}, "
          f"launches {nccl['nccl_step']['counts']} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the NCCL rank did not initialize and step")
    print(f"[parallel] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return {"shift3d": ddp[0]["counts"]["shift3d"],
            "shift3d_inverse": ddp[0]["counts"]["shift3d_inverse"],
            "shift_grad": ddp[0]["counts"]["shift_grad"],
            "fused_block": ranks[0]["test_models"]["counts"]["fused_block"],
            "fused_entry": ranks[0]["test_models"]["counts"]["fused_entry"],
            "shift2d": seq[0]["rubiks3d-aq"]["counts"]["shift2d"]}


# Phase 12: tensor parallelism (rubiksnet_torch.parallel's model group).
# Two ranks spawned on the one card as phase 11's are, through gloo, on a
# 1 x 2 (data x model) mesh: Large f32 at 8x224x224, max_shift 1, seed 0,
# sharded by JAX's default partition (the 71 + 2 + 5 largest 1x1 convs and
# new_fc, 79 weights). (a) One train step at batch 8 on each rank against
# one process from the same state: loss within 1e-6 relative, BN running
# statistics within 1e-6 of the largest entry (the products' reduction
# length is unchanged, only their output columns split), every gradient
# gathered within the header's 5e-2 (TOL_STEP_GRAD_E2E; the input
# gradients' all-reduce sums the ranks' parts in another order, which the
# ReLU kinks and the shifts' normalization magnify, phase 11 (a)), and the
# replicated parameters' gradients of the step bit-identical on both ranks
# (the step broadcasts the first rank's; the raw ones that differed before
# are printed); (b) the launches
# and the model group's collectives of that step counted on each rank;
# (c) the step timed beside one process's; (d) Large-AQ bf16 at batch 8
# in eval mode under the model group against unsharded; (e) the training
# entry point, train.py --model-parallel 2 --synthetic, whose checkpoint
# loads in one process and equals the gathered state.
TP_RANKS = 2
TOL_TP_LOSS, TOL_TP_BN = 1e-6, 1e-6
TP_SHARDED = 79  # weights JAX's default partition shards in Large
TP_SCRIPT_STEPS = 2


def counted_collectives(fn):
    """``counted(fn)`` with the model group's collectives counted too."""
    from rubiksnet_torch.parallel import collective_counters

    ctrs = collective_counters()
    for ctr in ctrs.values():
        ctr.reset()
    out, counts = counted(fn)
    counts.update({k: c.count for k, c in ctrs.items()})
    return out, counts


def job_tp_step(rank, group, spec, dev):
    """(a)-(c) One train step of Large f32 sharded over the model group,
    counted, its gradients gathered; then timed."""
    from rubiksnet_torch.parallel import (
        create_mesh, gather_shard, model_parallel, shard_params,
        sharded_modules,
    )
    from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult
    from rubiksnet_torch.train.steps import cross_entropy

    mesh = create_mesh(1, TP_RANKS)
    model = shard_params(large_train_model(dev), mesh.model)
    shards = {f"{n}.weight": m.shard for n, m in sharded_modules(model)}
    step = make_train_step(model, sgd_with_shift_mult(model, 0.01),
                           model_group=mesh.model)
    video, labels = parallel_batch(dev, 2)
    metrics, counts = counted_collectives(lambda: step(video, labels))
    loss, grads, stats = step_state(model, metrics)
    grads = {n: gather_shard(g.to(dev), shards[n], mesh.model).cpu()
             if n in shards else g for n, g in grads.items()}
    # The replicated parameters' gradients as each rank computes them,
    # before the step sets them to the first rank's.
    model.zero_grad(set_to_none=True)
    with model_parallel(mesh.model):
        cross_entropy(model(video), labels).backward()
    raw = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
           if n not in shards}
    return dict(loss=loss, counts=counts, grads=grads, stats=stats,
                raw=raw, sharded=sorted(shards),
                ms=wall_ms(lambda: step(video, labels)))


def job_tp_eval_aq(rank, group, spec, dev):
    """(d) Large-AQ bf16 at batch 8 through the eval step under the model
    group (the module path), counted."""
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet
    from rubiksnet_torch.parallel import create_mesh, shard_params
    from rubiksnet_torch.train import make_eval_step

    mesh = create_mesh(1, TP_RANKS)
    model = create_rubiksnet("large", CLASSES, FRAMES, "rubiks3d-aq",
                             max_shift=MAX_SHIFT, device=dev,
                             dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0))
    shard_params(model, mesh.model)
    video, labels = parallel_batch(dev, 3)
    fn = make_eval_step(model, model_group=mesh.model)
    out, counts = counted_collectives(lambda: fn(video[:, None], labels))
    return dict(logits=out["logits"].cpu(), counts=counts,
                ms=wall_ms(lambda: fn(video[:, None], labels)))


def job_tp_script(rank, group, spec, dev):
    """(e) train.py --model-parallel 2 on synthetic clips, counted; the
    final state gathered over the model group (the world here)."""
    import torch.distributed as dist

    from rubiksnet_torch.parallel import gather_params
    from rubiksnet_torch.scripts import train as train_script

    args = train_script.build_parser().parse_args(spec["tp_script_argv"])
    result, counts = counted_collectives(lambda: train_script.train(
        args, log=lambda *a: None))
    state = gather_params(result["model"], dist.group.WORLD)
    return dict(counts=counts, losses=result["losses"],
                val_batches=result["val_batches"],
                step_s=result["step_s"], wait_s=result["wait_s"],
                checkpoint=result["checkpoint"],
                state={k: v.cpu() for k, v in state.items()} if not rank
                else None)


PARALLEL_JOBS = {"temporal_op": job_temporal_op, "ddp": job_ddp,
                 "sequence_eval": job_sequence_eval,
                 "test_models": job_test_models, "nccl_step": job_nccl_step,
                 "tp_step": job_tp_step, "tp_eval_aq": job_tp_eval_aq,
                 "tp_script": job_tp_script}


def tensor_parallel_phase(dev, name, smi):
    """Phase 12 (see its comment above). Returns each kernel's launches on
    one rank's tensor-parallel paths: the train step (K1, K1-inverse, K4)
    and the Large-AQ eval batch (the 2D shift)."""
    import tempfile

    from rubiksnet_torch.models.rubiksnet import create_rubiksnet
    from rubiksnet_torch.parallel import param_partition_spec
    from rubiksnet_torch.scripts.train import latest_checkpoint
    from rubiksnet_torch.train import (
        load_train_state, make_eval_step, make_train_step,
        sgd_with_shift_mult,
    )

    t_phase = time.perf_counter()
    print(f"[tensor parallel] phase 12: {TP_RANKS} ranks on one card through "
          f"gloo, a 1 x {TP_RANKS} (data x model) mesh; {name} ({smi}). "
          f"The ranks share the card, so the times below describe the code "
          f"path, not a multi-card run")

    # The one-process references, before the ranks take the card.
    model = large_train_model(dev)
    spec = param_partition_spec(model, TP_RANKS)
    if sum(d == 0 for d in spec.values()) != TP_SHARDED:
        fail(f"Large's partition shards {sum(d == 0 for d in spec.values())} "
             f"weights, not {TP_SHARDED}")
    step = make_train_step(model, sgd_with_shift_mult(model, 0.01))
    video, labels = parallel_batch(dev, 2)
    ref_loss, ref_grads, ref_stats = step_state(model, step(video, labels))
    ref_step_ms = wall_ms(lambda: step(video, labels))
    del model, step, video, labels
    model = create_rubiksnet("large", CLASSES, FRAMES, "rubiks3d-aq",
                             max_shift=MAX_SHIFT, device=dev,
                             dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0))
    video, labels = parallel_batch(dev, 3)
    fn = make_eval_step(model)
    ref_aq = fn(video[:, None], labels)["logits"].cpu()
    ref_aq_ms = wall_ms(lambda: fn(video[:, None], labels))
    del model, fn, video, labels
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="rubiks_tp_") as root:
        argv = ["--synthetic", str(TP_SCRIPT_STEPS * TIME_BATCH),
                "--tier", "large", "--num-classes", str(CLASSES),
                "--frames", str(FRAMES), "--input-size", str(SIZE),
                "--batch-size", str(TIME_BATCH), "--steps",
                str(TP_SCRIPT_STEPS), "--save-every", str(TP_SCRIPT_STEPS),
                "--log-every", "1", "--model-parallel", str(TP_RANKS),
                "--checkpoint-dir", f"{root}/run", "--device", str(dev)]
        ranks = spawn_ranks(TP_RANKS, dict(
            jobs=["tp_step", "tp_eval_aq", "tp_script"],
            tp_script_argv=argv))
        path = latest_checkpoint(f"{root}/run")
        one = create_rubiksnet("large", CLASSES, FRAMES, device="cpu")
        loaded_step = load_train_state(path, one,
                                       sgd_with_shift_mult(one, 0.01))[0]
        loaded = one.state_dict()
    print(f"[tensor parallel] backend of the {TP_RANKS} ranks: "
          f"{[r['backend'] for r in ranks]}")
    if any(r["backend"] != "gloo" for r in ranks):
        fail("ranks that share a card must take gloo")

    # (b) The launches and collectives of one step.
    shifts = len(shift_inputs(TIME_BATCH, FRAMES))
    steps = [r["tp_step"] for r in ranks]
    zero = {k: 0 for k in steps[0]["counts"]}
    want = dict(zero, shift3d=shifts, shift3d_inverse=shifts,
                shift_grad=shifts, gather_channels=TP_SHARDED,
                model_all_reduce=TP_SHARDED, bn_relu_train=BN_SITES,
                bn_relu_train_backward=BN_SITES)
    for r, res in enumerate(steps):
        print(f"[tensor parallel] (b) rank {r}: launches and collectives of "
              f"one train step at batch {TIME_BATCH}: {res['counts']}")
        if res["counts"] != want:
            fail(f"TP step on rank {r}: {res['counts']} != {want}")
        if res["sharded"] != sorted(n for n, d in spec.items() if d == 0):
            fail(f"rank {r} sharded other weights than the partition")

    # (a) The step against one process.
    mask = {n: g.norm(dim=0) > SHIFT_CHANNEL_FLOOR * g.norm(dim=0).max()
            for n, g in ref_grads.items() if n.endswith(".shift")}
    loss_rel = max(abs(res["loss"] - ref_loss) / abs(ref_loss)
                   for res in steps)
    g_worst = max((errors(steps[0]["grads"][n][:, mask[n]] if n in mask
                          else steps[0]["grads"][n],
                          g[:, mask[n]] if n in mask else g)[2], n)
                  for n, g in ref_grads.items())
    bn_worst = max((errors(res["stats"][n], b)[1], n)
                   for res in steps for n, b in ref_stats.items())
    unlike = [n for n in ref_grads if spec[n] is None and not torch.equal(
        steps[0]["grads"][n], steps[1]["grads"][n])]
    raw_unlike = [(errors(steps[1]["raw"][n], steps[0]["raw"][n])[2], n)
                  for n in steps[0]["raw"]
                  if not torch.equal(steps[0]["raw"][n], steps[1]["raw"][n])]
    ok = (loss_rel <= TOL_TP_LOSS and g_worst[0] <= TOL_STEP_GRAD_E2E
          and bn_worst[0] <= TOL_TP_BN and not unlike)
    print(f"  (a) 1 x {TP_RANKS} model-sharded step vs one process, Large "
          f"f32 x {TIME_BATCH}: loss {steps[0]['loss']:.6f} vs "
          f"{ref_loss:.6f} (rel {loss_rel:.3e} [<= {TOL_TP_LOSS}]); worst "
          f"gradient rel_l2 {g_worst[0]:.3e} ({g_worst[1]}) [<= "
          f"{TOL_STEP_GRAD_E2E}]; worst BN statistic rel_max "
          f"{bn_worst[0]:.3e} ({bn_worst[1]}) [<= {TOL_TP_BN}]; replicated "
          f"gradients of the step on the two ranks "
          f"{'bit-identical' if not unlike else f'differ in {unlike}'}"
          f" {'ok' if ok else 'FAIL'}")
    print(f"  (a) the replicated gradients as each rank computes them, "
          f"before the step's broadcast of the first rank's: "
          f"{len(raw_unlike)} of {len(steps[0]['raw'])} differ between the "
          f"ranks {sorted(raw_unlike, reverse=True)[:5]} (rel_l2, name)")
    if not ok:
        fail("the model-sharded step disagrees with the one-process step")
    print(f"[tensor parallel] (c) train step, Large f32 {FRAMES}x{SIZE}x{SIZE} "
          f"x {TIME_BATCH}: 1 x {TP_RANKS} model-sharded on one card (gloo) "
          f"median {median(steps[0]['ms']):.1f} ms/step (rank 0, "
          f"{steps[0]['ms']}); one process median {median(ref_step_ms):.1f} "
          f"ms/step ({ref_step_ms}); host clock around synchronized steps, "
          f"{name} ({smi})")

    # (d) Large-AQ eval under the model group.
    aq = [r["tp_eval_aq"] for r in ranks]
    want = dict(zero, shift2d=shifts, gather_channels=TP_SHARDED)
    for r, res in enumerate(aq):
        same = torch.equal(res["logits"], ref_aq)
        _, rel_max, rel_l2 = errors(res["logits"], ref_aq)
        ok = (res["counts"] == want and rel_l2 <= TOL_MODEL_BF16
              and bool(torch.isfinite(res["logits"]).all()))
        print(f"[tensor parallel] (d) rank {r} Large rubiks3d-aq bf16 eval "
              f"x {TIME_BATCH} under the model group (module path): "
              f"launches {res['counts']}; logits vs unsharded "
              f"{'bit-identical' if same else 'differ'} (rel_max "
              f"{rel_max:.3e}, rel_l2 {rel_l2:.3e} [<= {TOL_MODEL_BF16}]) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"(d) model-sharded Large-AQ eval on rank {r}: launches "
                 f"{res['counts']} != {want} or logits disagree")
    print(f"[tensor parallel] (d) eval batch, Large rubiks3d-aq bf16 x "
          f"{TIME_BATCH}: 1 x {TP_RANKS} model-sharded median "
          f"{median(aq[0]['ms']):.1f} ms ({aq[0]['ms']}); unsharded module "
          f"path median {median(ref_aq_ms):.1f} ms ({ref_aq_ms}); {name} "
          f"({smi})")

    # (e) The training entry point.
    script = [r["tp_script"] for r in ranks]
    for r, res in enumerate(script):
        n_steps, n_val = len(res["losses"]), res["val_batches"]
        want = dict(zero, shift3d=shifts * (n_steps + n_val),
                    shift3d_inverse=shifts * n_steps,
                    shift_grad=shifts * n_steps,
                    bn_relu_train=BN_SITES * n_steps,
                    bn_relu_train_backward=BN_SITES * n_steps,
                    gather_channels=TP_SHARDED * (n_steps + n_val),
                    model_all_reduce=TP_SHARDED * n_steps)
        ok = (n_steps == TP_SCRIPT_STEPS and res["counts"] == want
              and all(math.isfinite(x) for x in res["losses"]))
        print(f"[tensor parallel] (e) rank {r}: train.py --model-parallel "
              f"{TP_RANKS} --synthetic, {n_steps} steps + {n_val} validation "
              f"batch(es): losses {[round(x, 4) for x in res['losses']]}, "
              f"step s {[round(x, 3) for x in res['step_s']]}, launches "
              f"{res['counts']} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"(e) train.py --model-parallel on rank {r}: {res['counts']}"
                 f" != {want} or a loss not finite")
    state = script[0]["state"]
    same = (loaded_step == TP_SCRIPT_STEPS and loaded.keys() == state.keys()
            and all(torch.equal(loaded[k], v) for k, v in state.items()))
    print(f"[tensor parallel] (e) checkpoint {os.path.basename(path)} (step "
          f"{loaded_step}) loaded in one process "
          f"{'equals' if same else 'DIFFERS from'} the gathered state bit "
          f"for bit ({len(state)} entries)")
    if not same:
        fail("(e) the model-parallel checkpoint does not load as the "
             "gathered state")
    print(f"[tensor parallel] phase 12 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {k: steps[0]["counts"][k]
            for k in ("shift3d", "shift3d_inverse", "shift_grad",
                      "bn_relu_train")} | {
        "shift2d": aq[0]["counts"]["shift2d"]}


# ---------------------------------------- phase 13: measurement entry points


def entry_point(label, module, argv):
    """``module.main(argv)`` in this process, as a user runs the script: its
    lines printed indented, its last line parsed; fails unless it exits 0
    with ``correct`` true."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = module.main(argv)
    lines = buf.getvalue().strip().splitlines()
    for ln in lines[:-1]:
        print(f"  {ln}")
    try:
        line = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError) as err:
        fail(f"{label}: the last line is not one JSON object ({err})")
    print(f"  {label}: exit {code}, correct {line.get('correct')}, "
          f"{time.perf_counter() - t0:.1f} s")
    if code != 0 or line.get("correct") is not True:
        fail(f"{label} exited {code} or is not correct")
    return line


def check_bench_line(label, line, name, want):
    """A bench line of the card: every point's launches those of phases
    1-8, its mfu and busy share in (0, 1]."""
    detail = line["detail"]
    if detail["device"] != name:
        fail(f"{label}: device {detail['device']!r}, not {name!r}")
    zero = dict.fromkeys(LAUNCH_COUNTERS, 0)
    for batch, p in detail["points"].items():
        if p["launches"] != k2_ring(dict(zero, **want)):
            fail(f"{label} batch {batch}: launches {p['launches']} != "
                 f"{want}")
        for key in ("mfu", "busy_share"):
            if p[key] is None or not 0 < p[key] <= 1:
                fail(f"{label} batch {batch}: {key} {p[key]} outside (0, 1]")
        print(f"  {label} batch {batch}: median {p['ms']['median']:.3f} ms "
              f"(p10 {p['ms']['p10']:.3f}, p90 {p['ms']['p90']:.3f}, "
              f"n={p['ms']['n']}), {p['clips_per_s']:.1f} clips/s, mfu "
              f"{p['mfu']:.4f}, hbm_share {p['hbm_share']:.4f}, busy share "
              f"{p['busy_share']:.3f}, peak {p['peak_memory_gib']:.2f} GiB; "
              f"launches as phases 1-8 ({name}, {detail['card']})")


def measurement_phase(errs, gen, cpu_gen, dev, name, smi):
    """Phase 13: the three measurement entry points of the port, in this
    process, on the card: the bench serving Large bf16 through the fused
    executor at MEASURE_SERVE_BATCHES (K2's and K3's plans there first held
    against plain) and training it at TIME_BATCH, the shift microbench at
    MICRO_STAGE (every mode and route), the data-pipeline bench over
    MEASURE_VIDEOS videos."""
    from rubiksnet_torch.data import native_loader
    from rubiksnet_torch.scripts import bench, data_pipeline_bench
    from rubiksnet_torch.scripts import shift_microbench
    from rubiksnet_torch.utils import fused_block_probe, fused_entry_probe

    t_phase = time.perf_counter()
    print(f"[measure] phase 13: the measurement entry points, {name} ({smi})")
    bf = torch.bfloat16
    new = [b for b in MEASURE_SERVE_BATCHES if (
        (b, FRAMES, 14, 14, 288), False, False) not in CHECKED_PLANS]
    for label, n, t, h, w, c, k, kind, blocks in (
            fused_block_probe.served_cases(new)):
        ok, max_abs, text, plan = fused_block_probe.check_case(
            label, (n, t, h, w, c), k, kind, blocks, False, False, bf, gen,
            cpu_gen, dev)
        print("  " + text)
        if not ok:
            fail(f"K2 {label} bf16 failed")
        CHECKED_PLANS[(n, t, h, w, c), False, False] = plan
        errs["fused_block"].append(max_abs)
    for label, n, t, h, w, cin, cm, k, kind in (
            fused_entry_probe.served_cases(new)):
        ok, max_abs, text, plan = fused_entry_probe.check_case(
            label, (n, t, h, w, cin), cm, k, kind, False, bf, gen, cpu_gen,
            dev)
        print("  " + text)
        if not ok:
            fail(f"K3 {label} bf16 failed")
        CHECKED_ENTRY_PLANS[(n, t, h, w, cin), cm, False, False] = plan
        errs["fused_entry"].append(max_abs)
    for b in MEASURE_SERVE_BATCHES:
        for h, c, _ in BLOCK_SHAPES:
            checked_plan((b, FRAMES, h, h, c), False, False, dev)
        for h, cin, cm in ENTRY_SHAPES:
            checked_entry_plan((b, FRAMES, h, h, cin), cm, False, dev)
    torch.cuda.empty_cache()

    line = entry_point("bench infer", bench, [
        "--tier", "large", "--batch-sizes",
        *map(str, MEASURE_SERVE_BATCHES), "--iters", "5"])
    check_bench_line("bench infer Large bf16 fused", line, name,
                     {"fused_block": 47, "fused_entry": 4, "stem_conv": 1})
    torch.cuda.empty_cache()
    line = entry_point("bench train", bench, [
        "--tier", "large", "--mode", "train", "--batch-sizes",
        str(TIME_BATCH), "--iters", "3"])
    check_bench_line("bench train Large bf16", line, name,
                     {"shift3d": 51, "shift3d_inverse": 51, "shift_grad": 51,
                      "bn_relu_train": BN_SITES,
                      "bn_relu_train_backward": BN_SITES})
    torch.cuda.empty_cache()

    stage = MICRO_STAGE[0]
    line = entry_point("shift_microbench", shift_microbench, [
        "--stages", stage, "--batch", str(MICRO_BATCH), "--rounds", "2"])
    if line["device"] != name:
        fail(f"shift_microbench: device {line['device']!r}, not {name!r}")
    want = {"fwd": {"kernel", "plain", "library"},
            "bwd": {"kernel", "plain"},
            "input_grad": {"kernel", "plain", "library"},
            "shift_grad": {"kernel", "plain"}}
    for mode, routes in want.items():
        cell = line["cases"][stage][mode]
        if set(cell["routes"]) != routes:
            fail(f"shift_microbench {mode}: routes {sorted(cell['routes'])}")
        print(f"  shift_microbench {stage} {mode}: " + ", ".join(
            f"{r} {row['median_ms']:.4f} ms" for r, row in
            cell["routes"].items()) + f"; winner {cell['winner']}, bound "
            f"{cell['bound_ms']:.4f} ms ({cell['bound_by']})")
    torch.cuda.empty_cache()

    line = entry_point("data_pipeline_bench", data_pipeline_bench, [
        "--videos", str(MEASURE_VIDEOS)])
    if line["device"] != name:
        fail(f"data_pipeline_bench: device {line['device']!r}")
    built = native_loader.toolchain_present()
    if line["native_built"] != built:
        fail(f"data_pipeline_bench: native built {line['native_built']}, "
             f"the toolchain probe says {built}")
    if line["device_built"] is not True:
        fail("data_pipeline_bench: the device loader did not build")
    for proto, entry in line["protocols"].items():
        row = entry["device"]
        print(f"  data_pipeline_bench {proto} device: "
              f"{row['ms_per_frame']:.4f} ms a frame, "
              f"{row['sec_per_video']:.5f} s/video, batches of "
              f"{row['batch_videos']} videos, {row['launches']} launches, "
              f"frames by route {row['backend_frames']}, against PIL mean "
              f"|diff| {row['mean_abs_diff']} max {row['max_abs_diff']}; PIL "
              f"{entry['pil']['ms_per_frame']:.4f} ms a frame ({name}, "
              f"{smi})")
    print(f"[measure] phase 13 took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from rubiksnet_torch.data import device_loader
    from rubiksnet_torch.ops import _build
    from rubiksnet_torch.ops.fused_block import (
        fold_blocks,
        fused_block_kernel,
        fused_block_plain,
    )
    from rubiksnet_torch.ops.fused_entry import (
        fused_entry_kernel,
        fused_entry_plain,
        stack_entry_params,
    )
    from rubiksnet_torch.ops.shift3d import shift3d_kernel, shift3d_plain
    from rubiksnet_torch.utils import nvidia_smi_line

    started = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 1: device.
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[device] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi name, power.limit: {smi}")

    # Phase 2: build: the kernels' library (one nvcc a source) and, at the
    # same time, the device loader's (device_loader.cu with nvjpeg).
    if not device_loader.toolchain_present():
        fail(f"the device loader needs nvcc and nvjpeg's header or library: "
             f"{json.dumps(device_loader.nvjpeg_files())}")
    t0 = time.perf_counter()
    loader_build = {}

    def build_loader():
        try:
            device_loader.load_library()
        except BaseException as err:  # re-raised below
            loader_build["error"] = err
        loader_build["s"] = time.perf_counter() - t0

    loader_thread = threading.Thread(target=build_loader)
    loader_thread.start()
    _build.load_library()
    kernels_s = time.perf_counter() - t0
    loader_thread.join()
    if "error" in loader_build:
        raise loader_build["error"]
    print(f"[build] kernels built and loaded in {kernels_s:.1f} s, the "
          f"device loader (nvjpeg, resize_crop_u8) in {loader_build['s']:.1f}"
          f" s, in parallel")

    gen = torch.Generator(device=dev).manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    errs = {k: [] for k in KERNELS}
    dtypes = (torch.float32, torch.bfloat16)

    # Phase 3: each kernel against its plain version at the Large shapes.
    print("[kernels] K1 shift3d (staged route, shift3d_bwd.cu) vs gather "
          "form")
    for h, c, s in SHIFT_SHAPES:
        for dt in dtypes:
            for q in (False, True):
                x = randn((BATCH_CHECK, FRAMES, h, h, c), dt, gen, dev)
                shift = (torch.rand((3, c), generator=gen, device=dev)
                         * 3.6 - 1.8)
                stride = (1, s, s)
                got = shift3d_kernel(x, shift, stride, (0, 0, 0), q)
                ref = shift3d_plain(x, shift, stride, (0, 0, 0), q)
                judge(f"K1 {h}x{h}x{c} stride {s} {str(dt)[6:]} "
                      f"{'quantize' if q else 'fractional'}", got, ref, dt,
                      errs["shift3d"])

    print("[kernels] K2 fused_block (2 blocks) vs plain")
    for h, c, _ in BLOCK_SHAPES:
        for dt in dtypes:
            for q in (False, True):
                blocks = [random_block(c, c, 1, q, cpu_gen, dev)
                          for _ in range(2)]
                vt, wm, _ = fold_blocks(blocks, dt, MAX_SHIFT, quantize=q)
                x = randn((BATCH_CHECK, FRAMES, h, h, c), dt, gen, dev)
                got = fused_block_kernel(x, vt, wm, max_shift=MAX_SHIFT)
                ref = fused_block_plain(x, vt, wm, max_shift=MAX_SHIFT)
                judge(f"K2 {h}x{h}x{c} {str(dt)[6:]} "
                      f"{'quantize' if q else 'fractional'}", got, ref, dt,
                      errs["fused_block"])

    print("[kernels] K3 fused_entry vs plain")
    for h, cin, cm in ENTRY_SHAPES:
        for dt in dtypes:
            for q in (False, True):
                blk = random_block(cin, cm, 2, q, cpu_gen, dev)
                params = stack_entry_params(blk, dt, MAX_SHIFT, q)
                x = randn((BATCH_CHECK, FRAMES, h, h, cin), dt, gen, dev)
                got = fused_entry_kernel(x, params, max_shift=MAX_SHIFT)
                ref = fused_entry_plain(x, params, max_shift=MAX_SHIFT)
                judge(f"K3 {h}x{h}x{cin}->{cm} {str(dt)[6:]} "
                      f"{'quantize' if q else 'fractional'}", got, ref, dt,
                      errs["fused_entry"])
    check_shift_staged(errs, gen, dev)
    check_new_kernels(errs, gen, cpu_gen, dev)
    check_block_cases(errs, gen, cpu_gen, dev)
    check_block_served_shapes(errs, gen, cpu_gen, dev)
    check_entry_cases(errs, gen, cpu_gen, dev)
    check_entry_served_shapes(errs, gen, cpu_gen, dev)
    check_bn_relu(errs, dev)
    check_stem(errs, gen, dev)
    torch.cuda.synchronize()
    print(f"[clock] kernel checks done at "
          f"{time.perf_counter() - started:.0f} s")

    timer = Timer(KERNELS)
    time_kernels(timer, gen, cpu_gen, dev, name, smi)
    print(f"[clock] kernel timing done at "
          f"{time.perf_counter() - started:.0f} s")

    # Phases 4-6, once per configuration: the whole model against the plain
    # model, the main path counted (one batch through the fused executor,
    # then through the unfused module path), serving.
    video = torch.randn((BATCH_CHECK, FRAMES, SIZE, SIZE, 3), generator=gen,
                        device=dev)
    batch = torch.randn((TIME_BATCH, FRAMES, SIZE, SIZE, 3), generator=gen,
                        device=dev)
    launches = {}
    configs = (
        ("Large rubiks3d", "large", "rubiks3d",
         {"fused_block": 47, "fused_entry": 4, "stem_conv": 1},
         {"shift3d": 51},
         {"fused_block": "fused_block", "fused_entry": "fused_entry",
          "stem_conv": "stem_conv"},
         {"shift3d": "shift3d"}),
        ("Large rubiks3d-aq", "large", "rubiks3d-aq",
         {"fused_block": 47, "fused_entry_aq": 4, "stem_conv": 1},
         {"shift2d": 51},
         {"fused_block_aq": "fused_block",
          "fused_entry_aq": "fused_entry_aq"}, {"shift2d": "shift2d"}),
        ("Small rubiks3d (SE)", "small", "rubiks3d",
         {"fused_block": 13, "fused_entry": 4, "se_gate": 17,
          "stem_conv": 1},
         {"shift3d": 17},
         {"fused_block_se": "fused_block", "fused_entry_se": "fused_entry",
          "se_gate": "se_gate"},
         {}),
    )
    for label, tier, variant, want_f, want_u, from_f, from_u in configs:
        models = build_models(tier, variant, dev)
        check_logits(label, models, video)
        model = models[torch.bfloat16]
        executor, fused, unfused = main_path(label, model, batch, want_f,
                                             want_u)
        launches.update({k: fused[ctr] for k, ctr in from_f.items()})
        launches.update({k: unfused[ctr] for k, ctr in from_u.items()})
        serve_phase(label, executor, model, gen, dev, name, smi,
                    aq=variant == "rubiks3d-aq", se=tier == "small")
        del models, model, executor
        torch.cuda.empty_cache()
        print(f"[clock] {label} done at "
              f"{time.perf_counter() - started:.0f} s")
    small_aq_check(dev, gen)

    # Phase 7: the device loader's kernel and decode, then the evaluator
    # end to end, its launches counted per run.
    loader_row = time_loader_kernel(dev, eval_phase(dev, name, smi), name,
                                    smi)
    torch.cuda.empty_cache()
    print(f"[clock] evaluator done at {time.perf_counter() - started:.0f} s")

    # Phase 8: training, each configuration's train step counted inside.
    train_launches = train_phase(dev, gen, name, smi)
    for k in ("shift3d_inverse", "shift_grad", "bn_relu_train"):
        launches[k] = train_launches[k]
    torch.cuda.empty_cache()
    aq_launches = train_config(
        "Large rubiks3d-aq", "large", "rubiks3d-aq",
        {"shift2d": 51, "shift2d_inverse": 51, "bn_relu_train": BN_SITES,
         "bn_relu_train_backward": BN_SITES}, dev, gen, name, smi)
    launches["shift2d_inverse"] = aq_launches["shift2d_inverse"]
    torch.cuda.empty_cache()
    train_config("Small rubiks3d (SE)", "small", "rubiks3d",
                 {"shift3d": 17, "shift3d_inverse": 17, "shift_grad": 17,
                  "bn_relu_train": SMALL_BN_SITES,
                  "bn_relu_train_backward": SMALL_BN_SITES},
                 dev, gen, name, smi)
    print(f"[clock] training done at {time.perf_counter() - started:.0f} s")

    # Phase 9: the training entry points, each run counted inside.
    train_script_phase(dev, gen, cpu_gen, name, smi)
    torch.cuda.empty_cache()
    print(f"[clock] training entry points done at "
          f"{time.perf_counter() - started:.0f} s")

    # Phase 10: serving export, the programs run in a fresh process.
    exported_launches = export_phase(dev, gen, cpu_gen, errs, name, smi)
    torch.cuda.empty_cache()
    print(f"[clock] serving export done at "
          f"{time.perf_counter() - started:.0f} s")

    # Phase 11: parallelism, ranks spawned on the card.
    t_phase = time.perf_counter()
    parallel_launches = parallel_phase(dev, gen, name, smi)
    torch.cuda.empty_cache()
    print(f"[clock] parallelism done at "
          f"{time.perf_counter() - started:.0f} s (phase 11: "
          f"{time.perf_counter() - t_phase:.1f} s)")

    # Phase 12: tensor parallelism, ranks spawned on the card.
    t_phase = time.perf_counter()
    tp_launches = tensor_parallel_phase(dev, name, smi)
    torch.cuda.empty_cache()
    print(f"[clock] tensor parallelism done at "
          f"{time.perf_counter() - started:.0f} s (phase 12: "
          f"{time.perf_counter() - t_phase:.1f} s)")

    # Phase 13: the measurement entry points, in this process.
    measurement_phase(errs, gen, cpu_gen, dev, name, smi)
    torch.cuda.empty_cache()
    print(f"[clock] measurement entry points done at "
          f"{time.perf_counter() - started:.0f} s")
    left = child_processes()
    if left:
        fail(f"processes started by this script still there: {left}")

    kernels = []
    for k, (source, replaces) in KERNELS.items():
        row = timer.rows[k]
        if launches[k] < 1:
            fail(f"kernel {k} was not launched on its main path")
        kernels.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": max(errs[k]), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                         else "operations"),
            "library_ms": row["library_ms"]})
        if row["device_ms"] is not None:
            kernels[-1].update(device_ms=row["device_ms"])
        if "runs_ms" in row:
            kernels[-1].update(runs_ms=row["runs_ms"])
        if "launch_a_added_ms" in row:
            kernels[-1].update(launch_a_added_ms=row["launch_a_added_ms"])
        if k in exported_launches:
            kernels[-1].update(exported_launches=exported_launches[k])
        if k in parallel_launches:
            kernels[-1].update(parallel_launches=parallel_launches[k])
        if k in tp_launches:
            kernels[-1].update(tensor_parallel_launches=tp_launches[k])
    if loader_row["launches"] < 1:
        fail("kernel resize_crop_u8 was not launched on its main path")
    kernels.append(loader_row)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
