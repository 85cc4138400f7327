"""Train-mode BN and its ReLU on the kernel pair (ops/csrc/bn_relu_train.cu)
alone on the card: what was compiled, a check against the plain ops, the
launches' times beside their bound, and whole train steps.

    python3 -m rubiksnet_torch.utils.bn_relu_probe --ptxas --check --time \\
        --step

``--ptxas`` compiles bn_relu_train.cu once more with ``-Xptxas -v`` and
prints each kernel's registers, spills and shared memory. ``--check`` holds
the forward (output, running statistics, count) and the backward (dx,
dweight, dbias) against :func:`ops.bn_relu.bn_train_plain` with
``torch.relu`` and autograd at every BN shape of a Large train step, in
bfloat16 at ``--batch`` clips (default 32) and float32 at a quarter of it,
and at CASES off the model (narrow rows, a misaligned view, one row), each
run twice and bit-identical. ``--time`` gives each shape's six launches'
device time by ``torch.profiler`` beside the bound (x read and the output
written forward, dy and x read and dx written backward, at 3.35 TB/s), the
plain ops' and ``F.batch_norm`` with ``F.relu``'s (the library's yardstick,
which the port never calls), and their sum over one Large train step.
``--step`` counts one Large bfloat16 train step's launches at ``--batch``,
times it against the same step with BN on the plain ops (parent and change
in turns in one process, CUDA events) with each one's peak memory, and
holds Large-AQ's and Small's float32 and bfloat16 steps at batch 8 to the
plain BN's loss and gradients. ``--host`` times the host's share of a call
on either route. Needs a CUDA card; prints its name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

from ..nn import backbone
from ..ops import _build, launch_counters
from ..ops.bn_relu import bn_relu_train, bn_train_plain
from .benchmark import (
    cuda_call_times_ms,
    cuda_kernel_times,
    cuda_time_ms,
    nvidia_smi_line,
)

FRAMES, SIZE, CLASSES = 8, 224, 174
HBM_BYTES_PER_S = 3.35e12
EPS = 1e-5
# Large's BN sites at 224 px: (H, C, sites in a train step); 103 in all.
SITES = [(112, 72, 4), (56, 72, 5), (56, 144, 1), (28, 144, 15),
         (28, 288, 1), (14, 288, 71), (14, 576, 1), (7, 576, 5)]
# Off the model: (label, shape, dtype, elements the view starts after).
CASES = [
    ("tiny tier's C=54", (2, 4, 28, 28, 54), torch.bfloat16, 0),
    ("C=54 float32", (2, 4, 28, 28, 54), torch.float32, 0),
    ("C=3, one load a channel", (3, 5, 7, 9, 3), torch.bfloat16, 0),
    ("a view 2 elements in", (2, 8, 14, 14, 288), torch.bfloat16, 2),
    ("one row", (1, 1, 1, 1, 576), torch.float32, 0),
    ("rows not a multiple of any lane", (3, 7, 13, 11, 144),
     torch.bfloat16, 0),
]
# Tolerances against the plain ops on the same inputs. Both sides take x
# in float32 and differ only in the order of the statistics' and the
# gradients' sums. A pre-activation within that difference of zero can
# flip its ReLU mask: a tie at float32's rounding, at most FLIPS of the
# elements; dx is compared where the masks agree, and each flip's own term
# (dy, dy xhat) is added to the plain dweight and dbias before they are
# compared. So:
# * bfloat16 output and dx: relative L2 1e-2 (an element is off by one
#   bf16 rounding, 2^-9, where the two float32 values straddle a rounding
#   boundary);
# * float32 output and dx: max |err| / max |ref| 1e-4 (summation order);
# * running statistics: max |err| / max |ref| 1e-5 (float32 sums of up to
#   3.2M rows in another order);
# * dweight and dbias: relative L2 1e-3 (float32 sums of up to 3.2M
#   mean-zero terms, which cancel).
TOL = {"out": {torch.bfloat16: 1e-2, torch.float32: 1e-4},
       "dx": {torch.bfloat16: 1e-2, torch.float32: 1e-4},
       "stats": 1e-5, "dparam": 1e-3}
FLIPS = 1e-5
# A train step at batch 8 of Large-AQ and Small, BN on the kernels against
# the plain ops, from one state. Float32: chip_smoke.py's whole-step
# bounds, the loss within 1e-5 and each leaf's gradient within 5e-2 of the
# larger of its norm and the median leaf's (portbench's leaf gap: a leaf
# whose gradient nearly cancels, an attention shift's or an SE layer's,
# moves by more than its own norm under any change of rounding). bfloat16:
# bench.py's loss tolerance; its leaf gaps printed.
TOL_STEP_LOSS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
TOL_STEP_GRAD = 5e-2


def ptxas_report() -> None:
    """Registers, spills and shared memory of every kernel of the file."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build._find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             "-o", f"{tmp}/k.o", str(_build.CSRC / "bn_relu_train.cu")],
            capture_output=True, text=True)
    print(f"[ptxas] bn_relu_train.cu: nvcc exit {proc.returncode}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            print("  " + line.split("'")[1][:60], "|", " ".join(
                lines[i + 1: i + 4]).replace("ptxas info    :", ""))
    if proc.returncode != 0:
        print(proc.stderr)
        raise RuntimeError("nvcc failed")


def inputs(shape, dtype, gen, dev, offset=0):
    """x with a mean and scale of its own per channel (one channel whose
    bias keeps it below zero), dy, and the BN's parameters and statistics."""
    c = shape[-1]
    scale = 0.5 + torch.rand(c, generator=gen, device=dev)
    mean = 2.0 * torch.randn(c, generator=gen, device=dev)
    n = torch.Size(shape).numel()
    flat = torch.empty(n + offset, dtype=dtype, device=dev)
    x = flat[offset:].view(shape)
    x.copy_(torch.randn(shape, generator=gen, device=dev) * scale + mean)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    weight = 0.5 + torch.rand(c, generator=gen, device=dev)
    bias = 0.5 * torch.randn(c, generator=gen, device=dev)
    bias[c // 2] = -1e3
    stats = (torch.randn(c, generator=gen, device=dev),
             0.5 + torch.rand(c, generator=gen, device=dev))
    return x, dy, weight, bias, stats


def run(route, x, dy, weight, bias, stats):
    """(out, dx, dweight, dbias, running_mean, running_var, count) of one
    forward and backward on ``route`` ("kernels" or "plain")."""
    rm, rv = (s.clone() for s in stats)
    nbt = torch.zeros((), dtype=torch.long, device=x.device)
    xg = x.detach().requires_grad_(True)
    wg = weight.detach().clone().requires_grad_(True)
    bg = bias.detach().clone().requires_grad_(True)
    if route == "kernels":
        out = bn_relu_train(xg, wg, bg, rm, rv, nbt, EPS)
    else:
        out = torch.relu(bn_train_plain(xg, wg, bg, rm, rv, nbt, EPS))
    out.backward(dy)
    return out.detach(), xg.grad, wg.grad, bg.grad, rm, rv, int(nbt)


def rel(got, ref, kind):
    got, ref = got.float(), ref.float()
    if kind == "l2":
        return float((got - ref).norm() / ref.norm().clamp_min(1e-30))
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def flip_terms(x, dy, flip, kernel_mask):
    """Each flipped mask's own terms of (dweight, dbias): dy xhat and dy,
    signed as the kernels' mask differs from the plain one."""
    dims = tuple(range(x.ndim - 1))
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=dims, correction=0)
    d = torch.where(flip, dy.float(), 0.0) * (2.0 * kernel_mask - 1.0)
    return ((d * (xf - mean) * torch.rsqrt(var + EPS)).sum(dims),
            d.sum(dims))


def check_one(label, x, dy, weight, bias, stats):
    """The kernels against the plain ops, and against themselves rerun."""
    dt = x.dtype
    k = run("kernels", x, dy, weight, bias, stats)
    again = run("kernels", x, dy, weight, bias, stats)
    p = run("plain", x, dy, weight, bias, stats)
    mask = k[0] > 0
    flip = mask != (p[0] > 0)
    flips = int(flip.sum())
    dw_p, db_p = p[2], p[3]
    if flips:
        dw_f, db_f = flip_terms(x, dy, flip, mask.float())
        dw_p, db_p = dw_p + dw_f, db_p + db_f
    kind = "l2" if dt == torch.bfloat16 else "max"
    errs = {"out": (rel(k[0], p[0], kind), TOL["out"][dt]),
            "dx": (rel(k[1][~flip], p[1][~flip], kind), TOL["dx"][dt]),
            "dweight": (rel(k[2], dw_p, "l2"), TOL["dparam"]),
            "dbias": (rel(k[3], db_p, "l2"), TOL["dparam"]),
            "running_mean": (rel(k[4], p[4], "max"), TOL["stats"]),
            "running_var": (rel(k[5], p[5], "max"), TOL["stats"])}
    same = all(torch.equal(a, b) for a, b in zip(k[:6], again[:6]))
    dead = int(x.shape[-1] // 2)
    ok = (all(e <= t for e, t in errs.values()) and same and k[6] == 1
          and flips <= FLIPS * x.numel()
          and not k[0][..., dead].any() and not k[1][..., dead].any())
    print(f"  {label} {str(dt)[6:]}: " + ", ".join(
        f"{n} {e:.2e} [<= {t:g}]" for n, (e, t) in errs.items())
        + f"; masks flipped {flips} of {x.numel()}; count {k[6]}; rerun "
        f"bit-identical {same} {'ok' if ok else 'FAIL'}")
    return ok, max(e for e, _ in errs.values())


def check(dev, batch) -> bool:
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    print(f"[check] the kernel pair vs the plain ops at Large's BN shapes, "
          f"bfloat16 at batch {batch}, float32 at {max(1, batch // 4)}")
    for h, c, _ in SITES:
        for dt, b in ((torch.bfloat16, batch),
                      (torch.float32, max(1, batch // 4))):
            ok &= check_one(f"{b}x{FRAMES}x{h}x{h}x{c}",
                            *inputs((b, FRAMES, h, h, c), dt, gen, dev))[0]
        torch.cuda.empty_cache()
    print("[check] off the model")
    for label, shape, dt, offset in CASES:
        ok &= check_one(label, *inputs(shape, dt, gen, dev, offset))[0]
    return ok


def time_sites(dev, batch):
    """Per shape, device ms of one forward and backward: the kernels by
    launch, the plain ops, the library; summed over a Large train step
    (with the kernels' time by CUDA events around each call, ``events``)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    totals = dict(kernels=0.0, plain=0.0, library=0.0, bound=0.0, events=0.0)
    print(f"[time] bfloat16 at batch {batch}: device ms of a forward and "
          f"backward ({nvidia_smi_line()})")
    for h, c, n in SITES:
        x, dy, weight, bias, stats = inputs((batch, FRAMES, h, h, c), bf, gen,
                                            dev)
        rm, rv = stats
        nbt = torch.zeros((), dtype=torch.long, device=dev)
        xg = x.detach().requires_grad_(True)
        wg = weight.detach().requires_grad_(True)
        bg = bias.detach().requires_grad_(True)

        def fresh():  # no gradient accumulation kernels in the window
            xg.grad = wg.grad = bg.grad = None

        def kernels():
            fresh()
            bn_relu_train(xg, wg, bg, rm, rv, nbt, EPS).backward(dy)

        def plain():
            fresh()
            torch.relu(bn_train_plain(xg, wg, bg, rm, rv, nbt, EPS)
                       ).backward(dy)

        x2, dy2 = xg.view(-1, c), dy.view(-1, c)

        def library():
            fresh()
            F.relu(F.batch_norm(x2, rm, rv, wg, bg, True, 0.1, EPS)
                   ).backward(dy2)

        launches = cuda_kernel_times(kernels)
        ms = {name: t / 5 for name, (_, t) in launches.items()}
        k_ms = sum(t for name, t in ms.items() if "bn_relu_train" in name)
        p_ms = sum(t for _, t in cuda_kernel_times(plain).values()) / 5
        l_ms = sum(t for _, t in cuda_kernel_times(library).values()) / 5
        bound = 5 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        ev_ms = cuda_time_ms(kernels)
        for key, v in zip(totals, (k_ms, p_ms, l_ms, bound, ev_ms)):
            totals[key] += n * v
        parts = ", ".join(f"{name.split('(')[0].split('::')[-1]} {t:.4f}"
                          for name, t in ms.items())
        print(f"  {h}x{h}x{c} (x{n}): kernels {k_ms:.4f} [{parts}], by "
              f"events {ev_ms:.4f}; bound "
              f"{bound:.4f} ({100 * bound / k_ms:.1f}%); plain {p_ms:.4f}; "
              f"library {l_ms:.4f}")
        del x, dy, xg, x2, dy2
        torch.cuda.empty_cache()
    print(f"[time] one Large train step's 103 sites: kernels "
          f"{totals['kernels']:.3f} ms, bound {totals['bound']:.3f} ms "
          f"({100 * totals['bound'] / totals['kernels']:.1f}%), plain "
          f"{totals['plain']:.3f} ms, library {totals['library']:.3f} ms; "
          f"by events {totals['events']:.3f} ms")
    return totals


def host(dev, calls=300) -> None:
    """Host microseconds a call, forward alone and forward with backward,
    on the kernels and on the plain ops, at a shape whose device work is
    shorter than the host's (2 clips at 7x7x576): the calls are enqueued
    back to back and the window closes on a synchronisation."""
    import time

    gen = torch.Generator(device=dev).manual_seed(3)
    x, dy, weight, bias, (rm, rv) = inputs((2, FRAMES, 7, 7, 576),
                                           torch.bfloat16, gen, dev)
    nbt = torch.zeros((), dtype=torch.long, device=dev)
    xg = x.detach().requires_grad_(True)
    wg = weight.detach().requires_grad_(True)
    bg = bias.detach().requires_grad_(True)

    def forward(route):
        if route == "kernels":
            return bn_relu_train(xg, wg, bg, rm, rv, nbt, EPS)
        return torch.relu(bn_train_plain(xg, wg, bg, rm, rv, nbt, EPS))

    def both(route):
        xg.grad = wg.grad = bg.grad = None
        forward(route).backward(dy)

    for route in ("kernels", "plain"):
        for label, fn in (("forward", forward), ("forward+backward", both)):
            for _ in range(20):
                fn(route)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(route)
            torch.cuda.synchronize()
            us = 1e6 * (time.perf_counter() - t0) / calls
            print(f"[host] {route} {label}: {us:.1f} us a call "
                  f"(2x{FRAMES}x7x7x576 bf16, {calls} calls)")


@contextlib.contextmanager
def bn_route(kernels):
    """BN on the kernel pair (the route as it is) or on the plain ops."""
    saved = backbone.kernel_route
    if not kernels:
        backbone.kernel_route = lambda *args: False
    try:
        yield
    finally:
        backbone.kernel_route = saved


def train_model(tier, variant, dev, dtype=torch.bfloat16):
    from ..models.rubiksnet import create_rubiksnet

    return create_rubiksnet(tier, CLASSES, FRAMES, variant, max_shift=1,
                            device=dev, dtype=dtype,
                            generator=torch.Generator().manual_seed(0)
                            ).train()


def counted_step(step, video, labels):
    counters = launch_counters()
    for ctr in counters.values():
        ctr.reset()
    loss = float(step(video, labels)["loss"])
    return loss, {k: c.count for k, c in counters.items() if c.count}


def step_pair(tier, variant, batch, dtype, dev, gen):
    """One step from one state with BN on the kernels and on the plain
    ops: (losses, the worst leaf gap and its leaf, launches). A leaf's gap
    is its gradients' distance over the larger of its norm and the median
    leaf's (portbench/compare.py's normalisation)."""
    from ..train import make_train_step, sgd_with_shift_mult

    video = torch.randn((batch, FRAMES, SIZE, SIZE, 3), generator=gen,
                        device=dev)
    labels = torch.randint(0, CLASSES, (batch,), generator=gen, device=dev)
    out = []
    for kernels in (True, False):
        model = train_model(tier, variant, dev, dtype)
        step = make_train_step(model, sgd_with_shift_mult(model, 0.01, 0.1))
        with bn_route(kernels):
            loss, launches = counted_step(step, video, labels)
        out.append((loss, {n: p.grad.float() for n, p in
                           model.named_parameters()}, launches))
        del model, step
    ref = out[1][1]
    median = statistics.median(float(g.norm()) for g in ref.values())
    worst = max((float((out[0][1][n] - g).norm())
                 / max(float(g.norm()), median), n) for n, g in ref.items())
    return out[0][0], out[1][0], worst, out[0][2]


def step(dev, batch) -> bool:
    from ..train import make_train_step, sgd_with_shift_mult

    gen = torch.Generator(device=dev).manual_seed(2)
    ok = True
    smi = nvidia_smi_line()
    model = train_model("large", "rubiks3d", dev)
    opt = sgd_with_shift_mult(model, 0.01, 0.1)
    train = make_train_step(model, opt)
    video = torch.randn((batch, FRAMES, SIZE, SIZE, 3), generator=gen,
                        device=dev)
    labels = torch.randint(0, CLASSES, (batch,), generator=gen, device=dev)
    _, launches = counted_step(train, video, labels)
    want = {"shift3d": 51, "shift3d_inverse": 51, "shift_grad": 51,
            "bn_relu_train": 103, "bn_relu_train_backward": 103}
    good = launches == want
    ok &= good
    print(f"[step] launches of one Large bf16 train step at batch {batch}: "
          f"{launches} {'ok' if good else 'FAIL'}")
    res = {True: [], False: []}
    peak = {}
    for kernels in (False, True, True, False):
        with bn_route(kernels):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res[kernels] += cuda_call_times_ms(lambda: train(video, labels),
                                               iters=6, warmup=2)
            peak[kernels] = torch.cuda.max_memory_allocated() / 1e9
    for kernels, label in ((False, "BN on the plain ops"),
                           (True, "BN on the kernel pair")):
        med = statistics.median(res[kernels])
        print(f"[step] Large bf16 batch {batch}, {label}: median {med:.2f} "
              f"ms a step ({min(res[kernels]):.2f}-{max(res[kernels]):.2f}, "
              f"n={len(res[kernels])}), {batch * 1e3 / med:.1f} clips/s, "
              f"peak memory {peak[kernels]:.2f} GB ({smi})")
    del model, opt, train, video, labels
    torch.cuda.empty_cache()
    for tier, variant, sites in (("large", "rubiks3d-aq", 103),
                                 ("small", "rubiks3d", 35)):
        for dt in (torch.float32, torch.bfloat16):
            lk, lp, (g, leaf), launches = step_pair(tier, variant, 8, dt,
                                                    dev, gen)
            loss_rel = abs(lk - lp) / abs(lp)
            gated = dt == torch.float32
            good = (loss_rel <= TOL_STEP_LOSS[dt]
                    and (g <= TOL_STEP_GRAD or not gated)
                    and launches.get("bn_relu_train") == sites
                    and launches.get("bn_relu_train_backward") == sites)
            ok &= good
            print(f"[step] {tier} {variant} {str(dt)[6:]} batch 8, BN "
                  f"kernels vs plain ops: loss {lk:.6f} vs {lp:.6f} (rel "
                  f"{loss_rel:.2e} [<= {TOL_STEP_LOSS[dt]}]); worst leaf gap "
                  f"{g:.2e} ({leaf})"
                  + (f" [<= {TOL_STEP_GRAD}]" if gated else "")
                  + f"; launches {launches} {'ok' if good else 'FAIL'}")
            torch.cuda.empty_cache()
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bn_relu_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {nvidia_smi_line()}; torch {torch.__version__}")
    if args.ptxas:
        ptxas_report()
    ok = True
    if args.check:
        ok &= check(dev, args.batch)
    if args.time:
        time_sites(dev, args.batch)
    if args.host:
        host(dev)
    if args.step:
        ok &= step(dev, args.batch)
    if not ok:
        print("bn_relu_probe: a comparison failed", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
