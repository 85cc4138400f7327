"""The serving stem's kernel (ops/csrc/stem.cu) on the card: its build, a
check against the plain version and its time beside the library's.

    python3 -m rubiksnet_torch.utils.stem_probe --ptxas --check --time

``--ptxas`` compiles ``stem.cu`` once more with ``-Xptxas -v`` and prints
each kernel's registers, spills and shared memory, beside K2's
(``fused_block_tc.cu``) and K3's (``fused_entry_tc.cu``). ``--check`` holds
the kernel to :func:`ops.stem.stem_conv_plain` (cuDNN, TF32 off) in bf16
and f32 at :data:`CASES` (224 px at batch 1, 8 and 64, 112 px, odd sizes,
width 54, inputs aligned to 4 and 2 bytes only), every run twice and
bit-identical, and bf16 also to the float64 sum of the same bf16 values
(one rounding: within one bf16 step). ``--time`` times, at 224 px and
``--batch`` clips of 8 frames (default 1, 8 and 64), in turns: the kernel
(ms by CUDA events around back-to-back calls, dev ms by ``torch.profiler``)
and the library call it replaced (``StemConv._conv``: the weight's cast
and cuDNN's padding pass and fprop, ``library_ms``), the plain version,
and the bound of ``utils/roofline.py::stem_work``. Needs a CUDA card;
prints its name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

from ..nn.backbone import StemConv
from ..ops import _build, stem
from .benchmark import cuda_kernel_times, cuda_time_ms, nvidia_smi_line
from .roofline import FRAMES, bound_times_ms, stem_work

C = 72  # the stem's width in Small, Medium and Large (Tiny: 54)
SIZE = 224
# (label, frames, H, W, C, byte offset of the input: 0, or 2 or 4 for a
# view that is aligned to that only).
CASES = [
    ("224 px, batch 1", FRAMES, SIZE, SIZE, C, 0),
    ("224 px, batch 8", 8 * FRAMES, SIZE, SIZE, C, 0),
    ("224 px, batch 64", 64 * FRAMES, SIZE, SIZE, C, 0),
    ("112 px, batch 8", 8 * FRAMES, 112, 112, C, 0),
    ("odd 33 x 45", 2 * FRAMES, 33, 45, C, 0),
    ("odd 45 x 33, width 54", 2 * FRAMES, 45, 33, 54, 0),
    ("224 px, width 54", 2 * FRAMES, SIZE, SIZE, 54, 0),
    ("56 x 42 (4-byte lines)", 3, 56, 42, C, 0),
    ("224 px, input at +4 bytes", 4, SIZE, SIZE, C, 4),
    ("64 px, input at +2 bytes", 5, 64, 64, C, 2),
    ("one frame 7 x 5", 1, 7, 5, C, 0),
]
TOL_F32_REL_MAX = 1e-4
TOL_BF16_REL_L2 = 1e-2
SOURCES = ("stem.cu", "fused_block_tc.cu", "fused_entry_tc.cu")


def _ptxas(src):
    with tempfile.TemporaryDirectory() as tmp:
        return subprocess.run(
            [_build._find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             "-o", f"{tmp}/out.o", str(_build.CSRC / src)],
            capture_output=True, text=True)


def ptxas_report() -> bool:
    """Registers, spills and shared memory of every kernel of stem.cu, K2's
    and K3's tensor-core sources (compiled in parallel)."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        procs = list(pool.map(_ptxas, SOURCES))
    ok = True
    for src, proc in zip(SOURCES, procs):
        print(f"[ptxas] {src}: nvcc exit {proc.returncode}")
        lines = (proc.stdout + proc.stderr).splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                print("  " + line.split("'")[1][:70], "|",
                      " ".join(lines[i + 1: i + 4]).replace(
                          "ptxas info    :", ""))
        if proc.returncode != 0:
            print(proc.stderr[-4000:])
            ok = False
    return ok


def frames_of(n, h, w, offset, dtype, gen, dev):
    """n frames (1, n, h, w, 3) of ``dtype`` starting ``offset`` bytes into
    a fresh allocation (0: aligned as the allocator aligns)."""
    x = torch.randn((n * h * w * 3 + 8,), generator=gen, device=dev)
    x = x.to(dtype)
    skip = offset // x.element_size()
    return x[skip: skip + n * h * w * 3].view(1, n, h, w, 3)


def packed_weight(c, dtype, gen, dev):
    conv = StemConv(c).to(dev)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen,
                                      device=dev) * 0.3)
    return conv, stem.pack_stem_weight(conv.weight, dtype)


def rel_errors(got, ref):
    got, ref = got.double(), ref.double()
    d = got - ref
    return (float(d.abs().max()) / max(float(ref.abs().max()), 1e-30),
            float(d.norm()) / max(float(ref.norm()), 1e-30))


def check(dev) -> bool:
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for label, n, h, w, c, offset in CASES:
        for dt in (torch.bfloat16, torch.float32):
            x = frames_of(n, h, w, offset, dt, gen, dev)
            _, wp = packed_weight(c, dt, gen, dev)
            before = stem.LAUNCHES.count
            got = stem.stem_conv_kernel(x, wp)
            again = stem.stem_conv_kernel(x, wp)
            ref = stem.stem_conv_plain(x, wp)
            torch.cuda.synchronize()
            same = torch.equal(got, again)
            rel_max, rel_l2 = rel_errors(got, ref)
            good = same and stem.LAUNCHES.count == before + 2
            if dt == torch.float32:
                good &= rel_max <= TOL_F32_REL_MAX
                extra = ""
            else:
                # One rounding of the exact sum: within half a bf16 step of
                # it (2^-9 relative), plus the sum's own f32 error.
                exact = stem.stem_conv_plain(x.double(), wp.double())
                step = (got.double() - exact).abs() / exact.abs().clamp_min(
                    1e-30)
                near = (got.double() - exact).abs() <= (
                    exact.abs() * 2.0 ** -8 + 1e-6)
                good &= rel_l2 <= TOL_BF16_REL_L2 and bool(near.all())
                extra = (f", vs the float64 sum: worst {float(step.max()):.2e}"
                         f" relative, {int((~near).sum())} beyond a bf16 step")
            ok &= bool(good)
            plan = (stem.stem_plan(h, w, c, 16 if offset == 0 else offset)
                    if dt == torch.bfloat16 else None)
            print(f"  {label} ({n}x{h}x{w} -> {c}) {str(dt)[6:]}: rel_max "
                  f"{rel_max:.2e} rel_l2 {rel_l2:.2e} vs plain, rerun "
                  f"{'bit-identical' if same else 'DIFFERS'}{extra}"
                  f"{f' [{plan}]' if plan else ''} "
                  f"{'ok' if good else 'FAIL'}")
    return ok


def time_stem(dev, batches) -> None:
    """The kernel beside the library call it replaced, in turns, at 224 px."""
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    for b in batches:
        n = b * FRAMES
        x = torch.randn((b, FRAMES, SIZE, SIZE, 3), generator=gen,
                        device=dev).to(bf)
        conv, wp = packed_weight(C, bf, gen, dev)
        kernel = lambda: stem.stem_conv_kernel(x, wp)
        library = lambda: conv._conv(x)
        plain = lambda: stem.stem_conv_plain(x, wp)
        by_mb, by_op = bound_times_ms(stem_work(n, SIZE, SIZE, C, 2), bf)
        rows = {"kernel": [], "library": []}
        devs = {"kernel": [], "library": []}
        with torch.no_grad():
            for turn in ("kernel", "library", "library", "kernel"):
                fn = kernel if turn == "kernel" else library
                rows[turn].append(cuda_time_ms(fn, iters=20))
                times = cuda_kernel_times(fn, iters=5)
                devs[turn].append(sum(ms for _, ms in times.values()) / 5)
                if turn == "library" and len(devs["library"]) == 1:
                    names = {k[:60]: (cnt / 5, ms / 5)
                             for k, (cnt, ms) in times.items()}
            plain_ms = cuda_time_ms(plain, iters=10)
        k_ms = sum(rows["kernel"]) / 2
        k_dev = sum(devs["kernel"]) / 2
        print(f"  batch {b} ({n} frames of {SIZE}x{SIZE}x3 -> {C}): kernel "
              f"{k_ms:.4f} ms ({rows['kernel']}), dev {k_dev:.4f} ms "
              f"({devs['kernel']}); library {sum(rows['library']) / 2:.4f} ms"
              f" ({rows['library']}), dev {sum(devs['library']) / 2:.4f} ms "
              f"({devs['library']}); plain {plain_ms:.4f} ms; bound "
              f"{max(by_mb, by_op):.4f} ms ({'B' if by_mb >= by_op else 'O'})"
              f": the kernel at {100 * max(by_mb, by_op) / k_dev:.1f}% of it")
        print(f"    the library's launches a call (count, dev ms): {names}")
        del x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8, 64])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stem_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"[device] {nvidia_smi_line()}; torch {torch.__version__}")
    if args.ptxas and not ptxas_report():
        print("stem_probe: nvcc failed", file=sys.stderr)
        return 1
    if args.check and not check(dev):
        print("stem_probe: a comparison failed", file=sys.stderr)
        return 1
    if args.time:
        time_stem(dev, args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
