"""Eager serving and training of two or more checkouts of the port, timed
in turns on one card.

    python3 -m rubiksnet_torch.utils.eager_ab \\
        --trees scratch_build/parent . --order 0,1,1,0,0,1

Each turn is a fresh process that imports ``rubiksnet_torch`` from the
checkout of that turn (its own kernels, built into its own build
directory) and times every configuration of :data:`CONFIGS`: bf16,
8x224x224, random weights (seed 0), ``max_shift`` 1; the fused executor at
batch 1 (Large, Large-AQ, Small), Large's module path at batch 1, and one
train step at batch 8 (Large, Large-AQ, Small). A call is timed by CUDA
events recorded back to back around each of :data:`CALLS` calls after 5
warm-ups, so where the host is slower than the card the time is the
host's. Prints, with the card's name and power limit, per configuration
and turn the median, min and max ms, then per checkout the median of all
its calls and its turns' medians. The worker uses only entry points that
every checkout of the port with a training step has, so an older commit,
unpacked into a git-ignored directory, runs it as it is.

Each turn also times the host's share of one call, the cost that
dispatch adds where the host limits a forward or a step: host
microseconds per call (best of 5 loops of 2000 calls on a small bf16
tensor, whose kernels take less than the host's share) of K1's and K2's
wrappers
(``shift3d_kernel``, ``fused_block_kernel``) beside the entry points the
model calls (``rubiks_shift_3d_forward``; ``rubiks_shift_3d`` with and
without autograd, as training and the module path call it;
``fused_block_run``, as the fused executor calls it).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

from .benchmark import nvidia_smi_line

# (label, tier, variant, mode, batch); mode: "fused" (FusedExecutor),
# "module" (the model's forward, no autograd) or "train" (one train step).
CONFIGS = (
    ("Large fused b1", "large", "rubiks3d", "fused", 1),
    ("Large-AQ fused b1", "large", "rubiks3d-aq", "fused", 1),
    ("Small fused b1", "small", "rubiks3d", "fused", 1),
    ("Large module path b1", "large", "rubiks3d", "module", 1),
    ("Large train b8", "large", "rubiks3d", "train", 8),
    ("Large-AQ train b8", "large", "rubiks3d-aq", "train", 8),
    ("Small train b8", "small", "rubiks3d", "train", 8),
)
CALLS = 60  # a configuration a turn
TURN_TIMEOUT_S = 600

# One turn: run in the checkout's directory, which Python puts first on
# the path for ``-c``.
WORKER = r"""
import json, sys, torch
from rubiksnet_torch.models import FusedExecutor, create_rubiksnet
from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult
from rubiksnet_torch.utils.benchmark import cuda_call_times_ms
configs, calls = json.loads(sys.argv[1]), int(sys.argv[2])
dev = torch.device("cuda", 0)
out = {}
for label, tier, variant, mode, batch in configs:
    gen = torch.Generator(device=dev).manual_seed(0)
    video = torch.randn((batch, 8, 224, 224, 3), generator=gen, device=dev)
    model = create_rubiksnet(tier, 174, 8, variant, max_shift=1,
                             device=dev, dtype=torch.bfloat16)
    if mode == "fused":
        executor = FusedExecutor(model.eval())
        fn = lambda: executor(video)
    elif mode == "module":
        model.eval()

        def fn():
            with torch.no_grad():
                return model(video)
    else:
        labels = torch.randint(0, 174, (batch,), generator=gen, device=dev)
        step = make_train_step(model.train(),
                               sgd_with_shift_mult(model, 0.01, 0.1))
        fn = lambda: step(video, labels)
    out[label] = cuda_call_times_ms(fn, iters=calls, warmup=5)
    del fn, model
    torch.cuda.empty_cache()
import time
from rubiksnet_torch.ops import fused_block as fb, shift3d as s3
bf = torch.bfloat16
model = create_rubiksnet("tiny", 174, 2, max_shift=1, device=dev, dtype=bf)
blocks = list(model.backbone.layer1)[1:2]
vt, wm = fb.stack_block_params(blocks, bf, 1)
xb = torch.randn((1, 2, 8, 8, blocks[0].in_planes), device=dev).to(bf)
x = torch.randn((1, 2, 8, 8, 64), device=dev).to(bf)
xg = x.clone().requires_grad_()
shift = torch.rand((3, 64), device=dev) - 0.5
shift_g = shift.clone().requires_grad_()
calls_of = {
    "K1 wrapper (shift3d_kernel)": lambda: s3.shift3d_kernel(x, shift),
    "K1 eager forward (rubiks_shift_3d_forward)":
        lambda: s3.rubiks_shift_3d_forward(x, shift),
    "K1 autograd op, no grad (rubiks_shift_3d)":
        lambda: s3.rubiks_shift_3d(x, shift),
    "K1 autograd op, grad (rubiks_shift_3d)":
        lambda: s3.rubiks_shift_3d(xg, shift_g),
    "K2 wrapper (fused_block_kernel)":
        lambda: fb.fused_block_kernel(xb, vt, wm, max_shift=1),
    "K2 eager (fused_block_run)":
        lambda: fb.fused_block_run(xb, vt, wm, max_shift=1),
}
host = {}
for label, fn in calls_of.items():
    for _ in range(50):
        fn()
    best = float("inf")
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        best = min(best, (time.perf_counter() - t0) / 2000 * 1e6)
    torch.cuda.synchronize()
    host[label] = best
out["dispatch"] = host
print("RESULT " + json.dumps(out))
"""


def run_turn(tree):
    """{label: [ms of each call], "dispatch": {entry: host µs per call}} of
    one fresh process in ``tree``."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    proc = subprocess.run(
        [sys.executable, "-c", WORKER, json.dumps(CONFIGS), str(CALLS)],
        cwd=tree, env=env, capture_output=True, text=True,
        timeout=TURN_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {tree} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True,
                    help="checkouts (directories holding rubiksnet_torch)")
    ap.add_argument("--order", default=None,
                    help="turns as indices into --trees, e.g. 0,1,1,0,0,1 "
                         "(default: each tree once, then in reverse)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("eager_ab: no CUDA device", file=sys.stderr)
        return 1
    order = ([int(i) for i in args.order.split(",")] if args.order else
             list(range(len(args.trees))) + list(
                 reversed(range(len(args.trees)))))
    smi = nvidia_smi_line()
    print(f"eager A/B, bf16 8x224x224, {CALLS} calls a configuration "
          f"a turn after 5 warm-ups, CUDA events back to back; {smi}")
    samples = {}  # (tree, label) -> [[ms of a turn], ...]
    for turn, i in enumerate(order):
        tree = args.trees[i]
        got = run_turn(tree)
        for label, us in got.get("dispatch", {}).items():
            samples.setdefault((tree, label), []).append(us)
            print(f"  turn {turn} {tree}: host share of one call, {label}: "
                  f"{us:.2f} µs", flush=True)
        for label, _, _, _, _ in CONFIGS:
            ms = sorted(got[label])
            samples.setdefault((tree, label), []).append(ms)
            print(f"  turn {turn} {tree}: {label}: median "
                  f"{statistics.median(ms):.3f} ms (min {ms[0]:.3f}, max "
                  f"{ms[-1]:.3f}, n={len(ms)})", flush=True)
    print(f"per checkout, all its calls ({smi}):")
    for label, _, _, _, _ in CONFIGS:
        for tree in args.trees:
            turns = samples.get((tree, label), [])
            if not turns:
                continue
            every = sorted(v for ms in turns for v in ms)
            print(f"  {label}: {tree}: median "
                  f"{statistics.median(every):.3f} ms, min {every[0]:.3f}, "
                  f"max {every[-1]:.3f}; turn medians "
                  + ", ".join(f"{statistics.median(ms):.3f}" for ms in turns))
    labels = [k for k in samples if not isinstance(samples[k][0], list)]
    if labels:
        print(f"host µs per call, best turn and every turn ({smi}):")
    for tree, label in labels:
        turns = samples[tree, label]
        print(f"  {label}: {tree}: {min(turns):.2f}; "
              + ", ".join(f"{us:.2f}" for us in turns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
