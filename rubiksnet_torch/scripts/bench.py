"""Serving and training throughput of the PyTorch port on one CUDA card.

Counterpart of ``bench.py`` (the JAX package's bench): RubiksNet with
random weights (seed 0), 174 classes, ``max_shift`` 1, 8 frames at 224 px
in bfloat16 by default, over a sweep of batch sizes, in one process, one
run per batch. Prints ONE JSON line last:

  {"metric": ..., "value": clips/s, "unit": "clips/s", "vs_baseline": x,
   "correct": true, "detail": {...}}

Baseline: the reference eval logs report 0.008 s/video for Large 1-clip
(BASELINE.md) = 125 clips/s, on an unspecified GPU; ``vs_baseline`` is the
best batch's clips/s over it (serving only).

Each batch, in this order and in this process:

* correctness: ``--mode infer``: the timed route's logits (the fused
  executor, or the unfused module path with ``--backend module``) against
  ``model(video, plain=True)``, relative L2 <= 5e-2 in bfloat16 and 1e-4 in
  float32, the whole-model bounds of ``chip_smoke.py`` (on the card this
  runs every K2 and K3 launch plan of that batch before it is timed);
  ``--mode train``: the first step's loss is finite and within 1e-2
  (bfloat16) or 1e-5 (float32) of the same step with the plain shift from
  the same state. That first call is also counted: ``launches`` holds each
  kernel's launches in one call (``ops.launch_counters()``).
* time: CUDA events around each of ``--iters`` calls after ``--warmup``
  (median, 10th and 90th percentiles, sample count); clips/s is the batch
  over the median. In train mode also the forward alone (eval mode, the
  module path), for ``train_step_over_forward``.
* busy share: one ``torch.profiler`` window of 5 of the same calls right
  after the timed ones (as ``utils/profile_step.py`` takes it): the union
  of the device's kernel, copy and memset intervals a call (``busy_ms``)
  over the untraced median, at most 1 (where the device is saturated the
  traced kernels ran up to 2% longer than the untraced call on an H100).
  ``profiled_ms`` is the traced window's time a call by CUDA events: the
  tracer's host cost shows there, not in the share. ``--trace DIR``
  writes that window's chrome trace.
* ``mfu``: ``utils/roofline.py::model_flops`` x calls/s over the card's
  peak for the dtype; ``hbm_share``: ``model_bytes`` x calls/s over 3.35
  TB/s; both printed beside the card's name and power limit.
* peak device memory (``torch.cuda.max_memory_allocated`` after a reset).

A batch that fails or is wrong stays in the line with its error and the
exit code is 1; clips/s of such a batch is left out of ``value``. Nothing
is merged across runs or processes. With ``--device cpu`` (for tests) the
clock is the host's, ``device`` says ``cpu`` and every device metric
(``mfu``, ``hbm_share``, busy share, peak memory) is null; without a card
and without ``--device cpu`` it raises.

Default batch sizes: serving 64, 96, 32, 128, 8, 1 (the JAX bench's, the
production points first); training 8, 16, 32, where the JAX bench runs the
serving list: the card has run Large's train step at those three, and
batch 64 and above has never been sized for memory.

Not carried over from the JAX bench: the supervising parent and its child
processes, budgets and retries, the best-of merge across children, the
stale fallback file, the chained-digest timers, the TPU peaks and XLA's
cost analysis, ``--scan-blocks`` and the TPU shift backends.

Usage: python -m rubiksnet_torch.scripts.bench [--tier large]
       [--variant rubiks3d] [--mode infer|train] [--batch-sizes N ...]
       [--sweep] [--backend fused|module] [--dtype bfloat16]
       [--iters 32] [--trace DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import sys
import traceback

import numpy as np
import torch

from ..models import FusedExecutor, create_rubiksnet
from ..models.rubiksnet import TIERS, VARIANTS, resolve_device
from ..ops import launch_counters
from ..train import make_train_step, sgd_with_shift_mult
from ..utils import (
    cuda_busy_ms,
    cuda_call_times_ms,
    host_call_times_ms,
    nvidia_smi_line,
)
from ..utils.roofline import (
    HBM_BYTES_PER_S,
    model_bytes,
    model_flops,
    peak_flops,
)

BASELINE_CLIPS_PER_SEC = 125.0  # 0.008 s/video, BASELINE.md
CLASSES, MAX_SHIFT, LR, SHIFT_MULT = 174, 1, 1e-3, 0.1
INFER_BATCHES = [64, 96, 32, 128, 8, 1]
TRAIN_BATCHES = [8, 16, 32]
SWEEP_BATCHES = [1, 2, 4, 8, 16, 32, 64, 96, 128, 192, 256]
PROFILED_CALLS = 5
# Logits against the plain model, relative L2 (chip_smoke.py's whole-model
# bounds: 51 residual blocks of bf16 roundings; f32 summation order).
TOL_LOGITS = {"bfloat16": 5e-2, "float32": 1e-4}
# The first train step's loss against the plain-shift step, relative. f32:
# chip_smoke.py's step bound. bf16: logits within 5e-2 relative L2 move a
# cross entropy near ln(174) = 5.16 by at most about 0.05.
TOL_LOSS = {"bfloat16": 1e-2, "float32": 1e-5}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tier", default="large", choices=sorted(TIERS))
    p.add_argument("--variant", default="rubiks3d", choices=VARIANTS)
    p.add_argument("--mode", default="infer", choices=["infer", "train"])
    p.add_argument("--batch-sizes", type=int, nargs="+", default=None,
                   help=f"default: {INFER_BATCHES} (infer), "
                        f"{TRAIN_BATCHES} (train)")
    p.add_argument("--sweep", action="store_true",
                   help=f"the full batch curve {SWEEP_BATCHES}")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--backend", default="fused", choices=["fused", "module"],
                   help="serving route: 'fused' = the FusedExecutor (K2, "
                        "K3), 'module' = the unfused forward (K1); "
                        "training always runs the module path")
    p.add_argument("--iters", type=int, default=32)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="write the profiled window of each batch as a "
                        "chrome trace into DIR")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card, which raises "
                        "where there is none")
    return p


def clip(batch, args, dev, dtype):
    """The (batch, frames, size, size, 3) input, normal from seed 0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    return torch.randn((batch, args.frames, args.size, args.size, 3),
                       generator=gen, device=dev).to(dtype)


def counted(fn):
    """(fn(), each kernel's launches in that call)."""
    counters = launch_counters()
    for ctr in counters.values():
        ctr.reset()
    out = fn()
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.synchronize()
    return out, {k: c.count for k, c in counters.items()}


def rel_l2(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def call_times(fn, args, dev):
    """Per-call ms: CUDA events on the card, the host clock on the CPU."""
    timer = cuda_call_times_ms if dev.type == "cuda" else host_call_times_ms
    return timer(fn, iters=args.iters, warmup=args.warmup)


def spread(ms):
    return {"median": float(np.median(ms)),
            "p10": float(np.percentile(ms, 10)),
            "p90": float(np.percentile(ms, 90)), "n": len(ms)}


def device_metrics(point, fn, args, dev, flops, nbytes, batch, label):
    """The busy share, mfu, HBM share and achieved rate of a timed point,
    all from this process at this batch; null on the CPU."""
    point.update(flops=flops, bytes=nbytes, mfu=None, hbm_share=None,
                 achieved_tflops=None, busy_ms=None, profiled_ms=None,
                 busy_share=None, device_records_per_call=None,
                 peak_memory_gib=None)
    if dev.type != "cuda":
        return
    path = None
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, f"{label}_batch{batch}.json")
    busy, window, records = cuda_busy_ms(
        fn, iters=min(PROFILED_CALLS, args.iters), trace_path=path)
    calls_per_s = 1e3 / point["ms"]["median"]
    point.update(
        mfu=flops * calls_per_s / peak_flops(DTYPES[args.dtype]),
        hbm_share=nbytes * calls_per_s / HBM_BYTES_PER_S,
        achieved_tflops=flops * calls_per_s / 1e12, busy_ms=busy,
        profiled_ms=window,
        busy_share=min(1.0, busy / point["ms"]["median"]),
        device_records_per_call=records,
        peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2**30)


def infer_point(args, model, forward, batch, dev):
    video = clip(batch, args, dev, model.dtype)
    with torch.no_grad():
        logits, launches = counted(lambda: forward(video))
        ref = model(video, plain=True)
        shape_ok = tuple(logits.shape) == (batch, CLASSES) and bool(
            torch.isfinite(logits.float()).all())
        err = rel_l2(logits, ref)
        del logits, ref
        tol = TOL_LOGITS[args.dtype]
        point = {"correct": shape_ok and err <= tol, "check": "logits",
                 "rel_l2": err, "tolerance": tol, "launches": launches}
        point["ms"] = spread(call_times(lambda: forward(video), args, dev))
        device_metrics(point, lambda: forward(video), args, dev,
                       model_flops(model, batch, args.frames, args.size),
                       model_bytes(model, batch, args.frames, args.size),
                       batch, f"infer_{args.tier}_{args.variant}")
    return point


def train_point(args, model, state, batch, dev):
    """One batch of training from ``state`` (the same for every batch)."""
    model.load_state_dict(state)
    video = clip(batch, args, dev, model.dtype)
    labels = torch.arange(batch, device=dev) % CLASSES
    plain_model = copy.deepcopy(model)
    step = make_train_step(model, sgd_with_shift_mult(model, LR, SHIFT_MULT))
    metrics, launches = counted(lambda: step(video, labels)["loss"])
    loss = float(metrics)
    plain_step = make_train_step(
        plain_model, sgd_with_shift_mult(plain_model, LR, SHIFT_MULT),
        plain=True)
    ref = float(plain_step(video, labels)["loss"])
    del plain_model, plain_step
    err = abs(loss - ref) / abs(ref)
    tol = TOL_LOSS[args.dtype]
    point = {"correct": math.isfinite(loss) and err <= tol,
             "check": "first step's loss", "loss": loss, "plain_loss": ref,
             "rel_err": err, "tolerance": tol, "launches": launches}
    point["ms"] = spread(call_times(lambda: step(video, labels), args, dev))
    device_metrics(point, lambda: step(video, labels), args, dev,
                   model_flops(model, batch, args.frames, args.size, "train"),
                   model_bytes(model, batch, args.frames, args.size, "train"),
                   batch, f"train_{args.tier}_{args.variant}")
    model.eval()
    with torch.no_grad():
        fwd = call_times(lambda: model(video), args, dev)
    point["forward_ms"] = float(np.median(fwd))
    point["train_step_over_forward"] = (point["ms"]["median"]
                                        / point["forward_ms"])
    return point


def model_name(args):
    aq = "-AQ" if args.variant == "rubiks3d-aq" else ""
    return f"RubiksNet-{args.tier.capitalize()}{aq}"


def run(args):
    """Measure every batch of ``args``: -> (the JSON line's dict, exit
    code)."""
    dev = resolve_device(args.device)
    batches = (SWEEP_BATCHES if args.sweep else args.batch_sizes
               or (TRAIN_BATCHES if args.mode == "train" else INFER_BATCHES))
    dtype = DTYPES[args.dtype]
    card = name = count = None
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        name, count = torch.cuda.get_device_name(dev), (
            torch.cuda.device_count())
        card = nvidia_smi_line()
    model = create_rubiksnet(args.tier, CLASSES, args.frames, args.variant,
                             max_shift=MAX_SHIFT, device=dev, dtype=dtype)
    if args.mode == "train":
        state = copy.deepcopy(model.state_dict())
    else:
        forward = FusedExecutor(model) if args.backend == "fused" else model
    points = {}
    for batch in batches:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            if args.mode == "train":
                point = train_point(args, model, state, batch, dev)
            else:
                point = infer_point(args, model, forward, batch, dev)
        except Exception as err:  # the batch stays in the line, failed
            traceback.print_exc()
            point = {"correct": False,
                     "failure": f"{type(err).__name__}: {err}"}
        if "ms" in point:
            point["clips_per_s"] = batch * 1e3 / point["ms"]["median"]
        points[str(batch)] = point
        print(f"[bench] {model_name(args)} {args.mode} batch {batch}: "
              + describe(point) + f" ({name or 'cpu'}, {card})", flush=True)
    good = {b: p["clips_per_s"] for b, p in points.items() if p["correct"]}
    best_batch = max(good, key=good.get) if good else None
    best = good[best_batch] if good else 0.0
    route = ("train" if args.mode == "train"
             else f"{args.backend}-backend inference")
    metric = (f"{'train ' if args.mode == 'train' else ''}clips/sec/chip "
              f"{model_name(args)} {args.frames}-frame {args.size}px "
              f"{args.dtype} {route}")
    detail = {
        "batch_sweep": good,
        "best_batch": int(best_batch) if good else None,
        "median_over_batches": float(np.median(list(good.values())))
        if good else 0.0,
        "utilization": {b: {k: p.get(k) for k in (
            "mfu", "hbm_share", "busy_share", "achieved_tflops")}
            for b, p in points.items() if "ms" in p},
        "device": name or dev.type, "device_count": count, "card": card,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "tier": args.tier, "variant": args.variant, "mode": args.mode,
        "backend": args.backend if args.mode == "infer" else "module",
        "dtype": args.dtype, "frames": args.frames, "size": args.size,
        "iters": args.iters, "warmup": args.warmup, "points": points,
    }
    if args.mode == "train":
        detail["train_step_over_forward"] = {
            b: p["train_step_over_forward"] for b, p in points.items()
            if "train_step_over_forward" in p}
    correct = bool(points) and all(p["correct"] for p in points.values())
    result = {
        "metric": metric, "value": best, "unit": "clips/s",
        "vs_baseline": (best / BASELINE_CLIPS_PER_SEC
                        if args.mode == "infer" else None),
        "correct": correct, "detail": detail,
    }
    return result, 0 if correct else 1


def describe(point):
    if "failure" in point:
        return f"FAILED: {point['failure']}"
    ms = point["ms"]
    text = (f"median {ms['median']:.3f} ms (p10 {ms['p10']:.3f}, p90 "
            f"{ms['p90']:.3f}, n={ms['n']}), {point['clips_per_s']:.1f} "
            f"clips/s")
    if point["mfu"] is not None:
        text += (f", mfu {point['mfu']:.4f}, hbm_share "
                 f"{point['hbm_share']:.4f}, busy {point['busy_share']:.3f} "
                 f"of {point['profiled_ms']:.3f} ms traced")
    check = point.get("rel_l2", point.get("rel_err"))
    return text + (f"; {point['check']} {check:.3e} [<= "
                   f"{point['tolerance']}] "
                   f"{'ok' if point['correct'] else 'WRONG'}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    result, code = run(args)
    print(json.dumps(result))
    return code


if __name__ == "__main__":
    sys.exit(main())
