"""The 3D shift op alone at RubiksNet-Large's four stage shapes, one row per
route, in interleaved rounds.

Counterpart of ``scripts/shift_microbench.py``. Stage shapes (batch,
8 frames, H, W, C) at ``--batch`` 64: 56x56x72, 28x28x144, 14x14x288,
7x7x576, stride 1. Modes:

* ``fwd``: the forward, ``ops.rubiks_shift_3d_forward``;
* ``bwd``: the forward and the full autograd backward of
  ``ops.rubiks_shift_3d`` (input gradient and normalized shift gradient);
* ``input_grad``: ``ops.rubiks_shift_3d_input_grad``;
* ``shift_grad``: ``ops.rubiks_shift_3d_shift_grad``, the raw (3, C)
  gradient.

Routes: ``kernel`` (the public functions: K1, K1-inverse and K4 on their
staged route), ``previous`` (the first forms, ``route="previous"``;
``bwd``: the forward, both gradients and the normalization on that
route), ``plain`` (the gather forms), and ``library`` where one PyTorch
call computes the same function: the depthwise ``conv3d`` over the
shift's tap weights for ``fwd``, ``conv_transpose3d`` for ``input_grad``.
The shift is U(-1, 1) (the model's init), where those 3x3x3 kernels hold
every tap.

Each route is first held against ``plain`` on the same inputs (float32:
max |err| / max |ref| <= 1e-4; bfloat16: relative L2 <= 1e-2; the shift
gradients relative L2 <= 1e-4 / 1e-3; the library twice the kernel's
bound: its 27 weights are rounded to the dtype), then timed: ``--rounds``
rounds, each route once a round in a seeded shuffled order, a sample being
CUDA events around ``--iters`` back-to-back calls (the host clock with
``--device cpu``, where ``previous`` has no form). Per route: the samples,
their median, and the median over rounds of its ratio to the round's
fastest route; per cell the ``winner`` (the lowest median ratio) and the
bound (``utils/roofline.py``: bytes over 3.35 TB/s or operations over the
float32 peak, the larger).

Prints one JSON line last, writes it to ``--out`` only when given; exits 1
if a route disagrees with plain or fails.

Usage: python -m rubiksnet_torch.scripts.shift_microbench [--batch 64]
       [--stages stage1,stage2,stage3,stage4]
       [--modes fwd,bwd,input_grad,shift_grad] [--rounds 5] [--iters 10]
       [--dtype bfloat16] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import numpy as np
import torch

from ..models.rubiksnet import resolve_device
from ..ops import shift3d as s3
from ..utils import cuda_time_ms, host_call_times_ms, nvidia_smi_line
from ..utils.roofline import (
    bound_times_ms,
    channel_last,
    library_shift,
    shift_grad_work,
    shift_work,
)

FRAMES = 8
STAGES = {"stage1": (56, 72), "stage2": (28, 144), "stage3": (14, 288),
          "stage4": (7, 576)}
MODES = ("fwd", "bwd", "input_grad", "shift_grad")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TOL_F32_REL_MAX, TOL_BF16_REL_L2 = 1e-4, 1e-2
TOL_SHIFT_GRAD = {"float32": 1e-4, "bfloat16": 1e-3}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--stages", default=",".join(STAGES),
                   help=f"comma subset of {list(STAGES)}")
    p.add_argument("--modes", default=",".join(MODES),
                   help=f"comma subset of {list(MODES)}")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--iters", type=int, default=10,
                   help="back-to-back calls a sample")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card, which raises "
                        "where there is none")
    p.add_argument("--out", default=None, help="also write the JSON here")
    return p


def _choice(text, allowed, what):
    picked = text.split(",")
    bad = [v for v in picked if v not in allowed]
    if bad:
        raise ValueError(f"unknown {what} {bad}; choose from {list(allowed)}")
    return picked


def errors(got, ref, measure):
    """(max |err|, the measure) of got against ref, in float32."""
    got, ref = got.float(), ref.float()
    d = got - ref
    if measure == "rel_max":
        value = float(d.abs().max() / ref.abs().max().clamp_min(1e-30))
    else:
        value = float(d.norm() / ref.norm().clamp_min(1e-30))
    return float(d.abs().max()), value


def stage_inputs(shape, dt, dev):
    """x and og normal, the (3, C) float32 shift U(-1, 1), from seeds."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=dev).to(dt)
    shift = torch.rand((3, shape[-1]), generator=gen, device=dev) * 2 - 1
    og = torch.randn(shape, generator=gen, device=dev).to(dt)
    return x, shift, og


def full_backward(x, shift, og, plain):
    """The autograd op's forward and backward: (input grad, shift grad)."""
    xg = x.detach().requires_grad_()
    sg = shift.detach().requires_grad_()
    out = s3.rubiks_shift_3d(xg, sg, plain=plain)
    return torch.autograd.grad(out, (xg, sg), og)


def previous_backward(x, shift, og):
    """The same on the previous route (shift3d.cu, shift_grad.cu)."""
    s3.shift3d_kernel(x, shift, route="previous")
    gx = s3.shift3d_input_grad_kernel(og, shift, x.shape, route="previous")
    gs = s3.shift3d_shift_grad_kernel(og, x, shift, route="previous")
    return gx, s3.normalize_shift_grad_3d(gs, 1.0)


def routes(mode, x, shift, og, cuda):
    """{route: callable} of one mode, and the work of one call."""
    n, shape = x.numel(), tuple(x.shape)
    item = x.element_size()
    fwd_work = shift_work(n, n, item, 8)
    grad_work = shift_work(n, n, item, 8)
    sgrad_work = shift_grad_work(n, n, item)
    if mode == "fwd":
        out = {"kernel": lambda: s3.rubiks_shift_3d_forward(x, shift),
               "plain": lambda: s3.shift3d_plain(x, shift),
               "library": library_shift(x, shift, 1)}
        if cuda:
            out["previous"] = lambda: s3.shift3d_kernel(x, shift,
                                                        route="previous")
        return out, fwd_work
    if mode == "input_grad":
        out = {"kernel": lambda: s3.rubiks_shift_3d_input_grad(og, shift,
                                                               shape),
               "plain": lambda: s3.shift3d_input_grad_plain(og, shift,
                                                            shape),
               "library": library_shift(og, shift, 1, inverse=True)}
        if cuda:
            out["previous"] = lambda: s3.shift3d_input_grad_kernel(
                og, shift, shape, route="previous")
        return out, grad_work
    if mode == "shift_grad":
        out = {"kernel": lambda: s3.rubiks_shift_3d_shift_grad(og, x, shift),
               "plain": lambda: s3.shift3d_shift_grad_plain(og, x, shift)}
        if cuda:
            out["previous"] = lambda: s3.shift3d_shift_grad_kernel(
                og, x, shift, route="previous")
        return out, sgrad_work
    out = {"kernel": lambda: full_backward(x, shift, og, False),
           "plain": lambda: full_backward(x, shift, og, True)}
    if cuda:
        out["previous"] = lambda: previous_backward(x, shift, og)
    work = tuple(a + b + c for a, b, c in zip(fwd_work, grad_work,
                                              sgrad_work))
    return out, work


def check(mode, route, got, ref, dtype):
    """{max_abs_err, measure, value, tolerance, correct} of one route."""
    if mode == "shift_grad":
        pairs = [(got, ref, "rel_l2", TOL_SHIFT_GRAD[dtype])]
    else:
        if route == "library":
            got = channel_last(got)
        outs = (got, ref) if mode == "bwd" else ((got,), (ref,))
        field = (("rel_max", TOL_F32_REL_MAX) if dtype == "float32"
                 else ("rel_l2", TOL_BF16_REL_L2))
        pairs = [(outs[0][0], outs[1][0], *field)]
        if mode == "bwd":
            pairs.append((outs[0][1], outs[1][1], "rel_l2",
                          TOL_SHIFT_GRAD[dtype]))
    row = {"max_abs_err": 0.0, "errors": [], "correct": True}
    for g, r, measure, tol in pairs:
        if route == "library":
            tol = 2 * tol
        if g.shape != r.shape or not torch.isfinite(g.float()).all():
            row["correct"] = False
            row["errors"].append({"measure": "shape or finite",
                                  "shape": list(g.shape)})
            continue
        max_abs, value = errors(g, r, measure)
        row["max_abs_err"] = max(row["max_abs_err"], max_abs)
        row["errors"].append({"measure": measure, "value": value,
                              "tolerance": tol})
        row["correct"] = row["correct"] and value <= tol
    return row


def sample_ms(fn, iters, cuda):
    """Mean ms a call over ``iters`` calls after one: CUDA events around
    the run on the card, the host clock on the CPU."""
    if cuda:
        return cuda_time_ms(fn, iters=iters, warmup=1)
    return float(np.mean(host_call_times_ms(fn, iters=iters, warmup=1)))


def interleave(fns, rounds, iters, cuda):
    """{route: {ms, median_ms, median_ratio_vs_best}}: every route once a
    round, in an order shuffled from the round's seed; a ratio is taken
    against the round's fastest, so drift between rounds divides out."""
    labels = list(fns)
    samples = {lb: [] for lb in labels}
    for rnd in range(rounds):
        for i in np.random.RandomState(rnd).permutation(len(labels)):
            samples[labels[i]].append(sample_ms(fns[labels[i]], iters, cuda))
    out = {}
    for lb in labels:
        ratios = [samples[lb][r] / min(samples[b][r] for b in labels)
                  for r in range(rounds)]
        out[lb] = {"ms": samples[lb],
                   "median_ms": float(np.median(samples[lb])),
                   "median_ratio_vs_best": float(np.median(ratios))}
    return out


def run_cell(mode, x, shift, og, args, cuda):
    fns, work = routes(mode, x, shift, og, cuda)
    ref = fns["plain"]()
    rows, failures = {}, {}
    for route, fn in fns.items():
        try:
            rows[route] = check(mode, route, fn(), ref, args.dtype)
        except Exception as err:  # the route stays in the line, failed
            traceback.print_exc()
            failures[route] = f"{type(err).__name__}: {err}"
    del ref
    timed = {r: fns[r] for r in rows}
    for route, times in interleave(timed, args.rounds, args.iters,
                                   cuda).items():
        rows[route].update(times)
    for route, why in failures.items():
        rows[route] = {"correct": False, "failure": why}
    tb, to = bound_times_ms(work, x.dtype)
    winner = min((r for r in rows if "median_ratio_vs_best" in rows[r]),
                 key=lambda r: rows[r]["median_ratio_vs_best"], default=None)
    return {"routes": rows, "winner": winner, "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def run(args):
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    stages = _choice(args.stages, STAGES, "stages")
    modes = _choice(args.modes, MODES, "modes")
    dt = DTYPES[args.dtype]
    name = card = None
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        name, card = torch.cuda.get_device_name(dev), nvidia_smi_line()
    result = {"metric": "shift op microbench", "device": name or dev.type,
              "card": card, "dtype": args.dtype, "batch": args.batch,
              "rounds": args.rounds, "iters": args.iters, "cases": {}}
    for stage in stages:
        h, c = STAGES[stage]
        shape = (args.batch, FRAMES, h, h, c)
        x, shift, og = stage_inputs(shape, dt, dev)
        case = result["cases"][stage] = {"shape": list(shape)}
        for mode in modes:
            cell = case[mode] = run_cell(mode, x, shift, og, args, cuda)
            for route, row in cell["routes"].items():
                text = (f"median {row['median_ms']:.4f} ms (ratio-vs-best "
                        f"{row['median_ratio_vs_best']:.2f})"
                        if "median_ms" in row else row.get("failure", ""))
                print(f"{stage} {mode} {route}: {text}; "
                      f"{'ok' if row['correct'] else 'FAIL'}", flush=True)
            print(f"{stage} {mode}: winner={cell['winner']} bound "
                  f"{cell['bound_ms']:.4f} ms ({cell['bound_by']}) "
                  f"({name or 'cpu'}, {card})", flush=True)
        del x, shift, og
        if cuda:
            torch.cuda.empty_cache()
    result["correct"] = all(
        row["correct"] for case in result["cases"].values()
        for mode, cell in case.items() if mode != "shape"
        for row in cell["routes"].values())
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
