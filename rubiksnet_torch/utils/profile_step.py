"""Where the device time of one serving batch or one train step goes.

    python3 -m rubiksnet_torch.utils.profile_step --tier large \\
        --variant rubiks3d-aq --mode train --batch 8

Builds the model (random weights, seed 0, bf16, 8 frames, 224 px), times
the unprofiled step with CUDA events, then traces a few steps with
``torch.profiler`` and prints the device time per step by kernel class,
the busy time and the idle share (1 - busy / unprofiled step time), and
the three kernels of the class "other" that take the most time, so that
unclassified time stays visible. Needs a CUDA card; prints the card's name
and power limit with the numbers.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..models.fused_infer import FusedExecutor
from ..models.rubiksnet import TIERS, VARIANTS, create_rubiksnet
from ..train import make_train_step, sgd_with_shift_mult
from .benchmark import cuda_call_times_ms, cuda_kernel_times, nvidia_smi_line

# (class, substrings of the kernel name), first match wins.
CLASSES = (
    ("2D shift and its input gradient (shift2d_kernel)", ("shift2d_kernel",)),
    ("K1 (bwd3d_forward_kernel; previous route shift3d_fwd_kernel)",
     ("bwd3d_forward", "shift3d_fwd_kernel")),
    ("K1-inverse (bwd3d_input_grad_kernel; previous route "
     "shift3d_inv_kernel)", ("bwd3d_input_grad", "shift3d_inv_kernel")),
    ("K4 (bwd3d_shift_grad_kernel; previous route shift_grad_*)",
     ("shift_grad",)),
    ("SE gate (se_gate_tc_kernel; SIMT route: se_partial, se_gate)",
     ("se_gate_tc_kernel", "se_partial_kernel", "se_gate_kernel")),
    ("K2 bf16 launches (rubiks_tc_kernel)", ("rubiks_tc_kernel",)),
    ("K3 bf16 launches (rubiks_entry_tc_kernel, rubiks_entry_gather_kernel)",
     ("rubiks_entry",)),
    ("float32 K2 and K3 GEMMs (gemm_kernel)", ("rubiks",)),
    ("library GEMMs (1x1 convs, dense)", ("gemm", "cutlass", "xmma", "gemv",
                                          "cublas", "nvjet")),
    ("library convolution (stem)", ("conv", "cudnn", "nchw", "nhwc")),
    ("reductions", ("reduce",)),
    ("gather / scatter / index", ("gather", "scatter", "index")),
    ("elementwise, copies, casts", ("elementwise", "vectorized", "copy",
                                    "Memcpy", "Memset", "fill", "cat")),
)


def classify(name: str) -> str:
    for label, needles in CLASSES:
        if any(n in name for n in needles):
            return label
    return "other"


def build_step(args, dev):
    """The callable of one serving batch or one train step."""
    gen = torch.Generator(device=dev).manual_seed(0)
    video = torch.randn((args.batch, args.frames, args.size, args.size, 3),
                        generator=gen, device=dev)
    model = create_rubiksnet(args.tier, args.classes, args.frames,
                             args.variant, max_shift=1, device=dev,
                             dtype=torch.bfloat16)
    if args.mode == "serve":
        executor = FusedExecutor(model)
        return lambda: executor(video)
    labels = torch.randint(0, args.classes, (args.batch,), generator=gen,
                           device=dev)
    step = make_train_step(model.train(),
                           sgd_with_shift_mult(model, 0.01, 0.1))
    return lambda: step(video, labels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tier", choices=sorted(TIERS), default="large")
    ap.add_argument("--variant", choices=VARIANTS, default="rubiks3d")
    ap.add_argument("--mode", choices=("serve", "train"), default="train")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--classes", type=int, default=174)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    fn = build_step(args, dev)
    ms = sorted(cuda_call_times_ms(fn, iters=5, warmup=3))
    step_ms = ms[len(ms) // 2]
    by_class, launches, other = {}, {}, []
    for key, (count, total_ms) in cuda_kernel_times(
            fn, iters=args.steps, warmup=0).items():
        label = classify(key)
        by_class[label] = by_class.get(label, 0.0) + total_ms
        launches[label] = launches.get(label, 0) + count
        if label == "other":
            other.append((total_ms, count, key))
    busy = sum(by_class.values()) / args.steps
    print(f"{args.tier} {args.variant} {args.mode} batch {args.batch} bf16 "
          f"{args.frames}x{args.size}x{args.size}, {nvidia_smi_line()}")
    print(f"unprofiled: median {step_ms:.3f} ms (min {ms[0]:.3f}, max "
          f"{ms[-1]:.3f}, n={len(ms)})")
    for label, total in sorted(by_class.items(), key=lambda kv: -kv[1]):
        per = total / args.steps
        print(f"  {label}: {per:.3f} ms per step, {100 * per / busy:.1f}% of "
              f"busy, {launches[label] / args.steps:.0f} launches")
    for total, count, key in sorted(other, reverse=True)[:3]:
        print(f"    other: {total / args.steps:.3f} ms per step, "
              f"{count / args.steps:.0f} launches: {key[:100]}")
    print(f"device busy {busy:.3f} ms per step; idle share "
          f"{100 * max(0.0, 1 - busy / step_ms):.1f}% of the unprofiled step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
