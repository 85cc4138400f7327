"""The 2D shift kernels (ops/csrc/shift2d.cu) on the card: a first check and
a sweep of the plan's knobs.

    python3 -m rubiksnet_torch.utils.shift2d_probe --check
    python3 -m rubiksnet_torch.utils.shift2d_probe --sweep
    python3 -m rubiksnet_torch.utils.shift2d_probe --host

``--check`` compiles the source once more with ``-Xptxas -v`` and prints
each kernel's registers, spills and shared memory, then compares forward
and input gradient with their plain versions at the nine Large-AQ shapes
(16 frames, f32 and bf16, fractional and quantized). ``--sweep`` times
both, bf16 at 64 frames, under several settings of the plan's knobs
(``ops/shift2d.py``: SMEM_BUDGET, TARGET_BLOCKS, MIN_BAND_ROWS,
BLOCK_THREADS, MAX_GROUP): device time per launch by ``torch.profiler``,
and the time per call by CUDA events around back-to-back calls, which
includes the host's share. ``--host`` times the enqueue alone (host clock,
no synchronisation) of the wrappers and the library call at the smallest
stage. Needs a CUDA card; prints its name and power
limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time

import torch

from ..ops import _build, shift2d
from .benchmark import cuda_kernel_times, cuda_time_ms, nvidia_smi_line

SHAPES = [(112, 72, 1), (56, 72, 1), (28, 144, 1), (14, 288, 1), (7, 576, 1),
          (112, 72, 2), (56, 144, 2), (28, 288, 2), (14, 576, 2)]
KNOBS = ("SMEM_BUDGET", "TARGET_BLOCKS", "MIN_BAND_ROWS", "BLOCK_THREADS",
         "MAX_GROUP", "MAX_RING")
SETTINGS = [
    {},
    {"MIN_BAND_ROWS": 4, "TARGET_BLOCKS": 1056},
    {"TARGET_BLOCKS": 4224},
    {"MAX_GROUP": 128},
    {"MAX_RING": 4},
    {"MAX_RING": 8},
    {"BLOCK_THREADS": 512},
    {"SMEM_BUDGET": 224 * 1024, "TARGET_BLOCKS": 132},
    {},
]


def ptxas_report() -> None:
    src = _build.CSRC / "shift2d.cu"
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build._find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             "-o", f"{tmp}/shift2d.o", str(src)],
            capture_output=True, text=True)
    print(f"[ptxas] nvcc exit {proc.returncode}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            print("  " + line.split("'")[1][:60], "|",
                  " ".join(lines[i + 1: i + 4]).replace("ptxas info    :", ""))
    if proc.returncode != 0:
        print(proc.stderr)
        raise RuntimeError("nvcc failed")


def rel_errors(got, ref):
    got, ref = got.float(), ref.float()
    d = got - ref
    return (float(d.abs().max()) / max(float(ref.abs().max()), 1e-30),
            float(d.norm()) / max(float(ref.norm()), 1e-30))


def check(dev) -> bool:
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for h, c, s in SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((16, h, h, c), generator=gen, device=dev).to(dt)
            shift = torch.rand((2, c), generator=gen, device=dev) * 3.6 - 1.8
            shift[:, ::4] = (shift[:, ::4] * 2).round() / 2
            for q in (False, True):
                got = shift2d.shift2d_kernel(x, shift, s, 0, q)
                ref = shift2d.shift2d_plain(x, shift, s, 0, q)
                og = torch.randn(got.shape, generator=gen,
                                 device=dev).to(dt)
                got_i = shift2d.shift2d_input_grad_kernel(og, shift, x.shape,
                                                          s, 0, q)
                ref_i = shift2d.shift2d_input_grad_plain(og, shift, x.shape,
                                                         s, 0, q)
                torch.cuda.synchronize()
                for tag, a, b in (("fwd", got, ref), ("inv", got_i, ref_i)):
                    rel_max, rel_l2 = rel_errors(a, b)
                    good = (torch.equal(a, b) if q else
                            rel_max <= 1e-4 if dt == torch.float32
                            else rel_l2 <= 1e-2)
                    ok &= bool(good)
                    print(f"  {tag} {h}x{h}x{c} stride {s} {str(dt)[6:]} "
                          f"{'quantize' if q else 'fractional'}: rel_max "
                          f"{rel_max:.2e} rel_l2 {rel_l2:.2e} "
                          f"{'ok' if good else 'FAIL'}")
    return ok


def device_ms(fn, iters=5):
    """(device ms per call of the shift2d kernel, kernels per call)."""
    times = cuda_kernel_times(fn, iters=iters)
    total = sum(ms for k, (_, ms) in times.items() if "shift2d_kernel" in k)
    return total / iters, sum(n for n, _ in times.values()) / iters


def host_us(fn, calls=2000):
    """Host microseconds per call of ``fn()``: the time to enqueue, no
    synchronisation inside the window (the device keeps up or the queue
    fills: use it at shapes whose kernels are short)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def host(dev) -> None:
    """The host's share at the smallest stage: the wrappers beside the
    library calls, through the autograd op too."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn((64, 7, 7, 576), generator=gen, device=dev).to(bf)
    shift = torch.rand((2, 576), generator=gen, device=dev) * 2 - 1
    w = torch.randn((576, 1, 3, 3), generator=gen, device=dev).to(bf)
    xp = x.permute(0, 3, 1, 2)
    cases = {
        "shift2d_kernel": lambda: shift2d.shift2d_kernel(x, shift),
        "shift2d_input_grad_kernel": lambda: shift2d.shift2d_input_grad_kernel(
            x, shift, x.shape),
        "rubiks_shift_2d (autograd op)": lambda: shift2d.rubiks_shift_2d(
            x, shift),
        "library conv2d, depthwise": lambda: F.conv2d(xp, w, padding=1,
                                                      groups=576),
        "torch.empty_like": lambda: torch.empty_like(x),
    }
    for label, fn in cases.items():
        print(f"  host {label}: {host_us(fn):.2f} us per call at 7x7x576, "
              f"64 frames")


def sweep(dev) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    defaults = {k: getattr(shift2d, k) for k in KNOBS}
    totals = {}
    counts = dict(zip(SHAPES, (1, 2, 7, 35, 2, 1, 1, 1, 1)))
    for h, c, s in SHAPES:
        x = torch.randn((64, h, h, c), generator=gen, device=dev).to(bf)
        shift = torch.rand((2, c), generator=gen, device=dev) * 2 - 1
        out_shape = shift2d.compute_output_shape_2d(x.shape, s, 0)
        og = torch.randn(out_shape, generator=gen, device=dev).to(bf)
        for i, setting in enumerate(SETTINGS):
            for k in KNOBS:
                setattr(shift2d, k, setting.get(k, defaults[k]))
            shift2d._prepare.cache_clear()
            fwd = lambda: shift2d.shift2d_kernel(x, shift, s)
            inv = lambda: shift2d.shift2d_input_grad_kernel(og, shift,
                                                            x.shape, s)
            plan = shift2d.shift2d_plan(x.shape, out_shape, s, bf)
            plan_i = shift2d.shift2d_plan(x.shape, out_shape, s, bf, True)
            (f_dev, f_n), (i_dev, i_n) = device_ms(fwd), device_ms(inv)
            f_evt, i_evt = cuda_time_ms(fwd, iters=20), cuda_time_ms(
                inv, iters=20)
            t = totals.setdefault(i, [0.0, 0.0, 0.0, 0.0])
            for j, v in enumerate((f_dev, i_dev, f_evt, i_evt)):
                t[j] += counts[h, c, s] * v
            print(f"  {h}x{h}x{c} stride {s} {setting or 'defaults'}: fwd "
                  f"device {f_dev:.4f} ms ({f_n:.0f} kernel/call) events "
                  f"{f_evt:.4f} ms [G{plan.group} R{plan.rows} D{plan.ring} "
                  f"x{plan.cols}]; inv device {i_dev:.4f} ms ({i_n:.0f}) "
                  f"events {i_evt:.4f} ms [G{plan_i.group} R{plan_i.rows} "
                  f"D{plan_i.ring} x{plan_i.cols}]")
    for k in KNOBS:
        setattr(shift2d, k, defaults[k])
    shift2d._prepare.cache_clear()
    print("[sweep] summed over Large-AQ's 51 launches, ms: fwd device, inv "
          "device, fwd events, inv events")
    for i, t in totals.items():
        print(f"  {SETTINGS[i] or 'defaults'}: "
              + ", ".join(f"{v:.3f}" for v in t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("shift2d_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"[device] {nvidia_smi_line()}; torch {torch.__version__}")
    if args.check:
        ptxas_report()
        if not check(dev):
            print("shift2d_probe: a comparison failed", file=sys.stderr)
            return 1
    if args.host:
        host(dev)
    if args.sweep:
        sweep(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
