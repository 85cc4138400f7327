"""The 3D shift's kernels on their staged route (ops/csrc/shift3d_bwd.cu:
K1, the forward; K1-inverse, the input gradient; K4, the shift gradient)
alone on the card: what was compiled, a check, the host's share and a sweep
of the plan's knobs.

    python3 -m rubiksnet_torch.utils.shift3d_bwd_probe --ptxas --check
    python3 -m rubiksnet_torch.utils.shift3d_bwd_probe --host --sweep
    python3 -m rubiksnet_torch.utils.shift3d_bwd_probe --ptxas \\
        --parent OTHER_CHECKOUT

``--ptxas`` compiles shift3d_bwd.cu once more with ``-Xptxas -v`` and prints
each kernel's registers, spills and shared memory; with ``--parent`` also those
of the shift3d_bwd.cu of another checkout of the repository (its root), so that
two versions of the body compare in one run. ``--check`` holds the three
kernels against their plain versions at the nine shift shapes of Large (2 clips
of 8 frames; float32 and bfloat16; the forward and the input gradient
fractional and quantized; every fourth channel an exact integer) and at CASES
(C = 54 and 108, odd extents, stride (2, 2, 2) with padding (1, 1, 1), stride
(1, 2, 2) with padding (0, 1, 0), one clip, shifts of +-9 that take the
direct-read route), each run twice and bit-identical. ``--sweep`` times the
three, bfloat16 at 8 clips (or ``--batch``), at the nine shapes under several
settings of the plan's knobs (``ops/shift3d.py``: BWD_SMEM_BUDGET,
BWD_MAX_GROUP, BWD_MAX_RING, BWD_TARGET_BLOCKS, BWD_MIN_BAND_ROWS,
BWD_BLOCK_THREADS), device time per call by ``torch.profiler``, summed over the
calls of one Large forward (K1) or train step. ``--host`` times the enqueue
alone (host clock, no synchronisation) of the three wrappers at the smallest
shape. ``--trace``, alone (its build's marks change registers and times),
builds the kernels with BWD3D_TRACE and prints when the blocks of one launch
reach the stages of their lives. Needs a CUDA card; prints its name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..ops import _build
from ..ops import shift3d as s3
from .benchmark import cuda_kernel_times, nvidia_smi_line

FRAMES = 8
# Large's shift shapes at 224 px as (H, C, stride, calls per train step):
# the stride-1 blocks and the mid tensors of the (1, 2, 2) entries.
SHAPES = [(112, 72, 1, 1), (56, 72, 1, 2), (28, 144, 1, 7), (14, 288, 1, 35),
          (7, 576, 1, 2), (112, 72, 2, 1), (56, 144, 2, 1), (28, 288, 2, 1),
          (14, 576, 2, 1)]
# Off the model's shapes: (label, N, T, H, W, C, stride, padding, shift
# kind). Kinds: "mixed" U(-1.8, 1.8) with every fourth channel an exact
# integer; "far": +-9 (more frames and rows than the ring holds: the
# direct-read route) in every other channel of the first eight.
CASES = [
    ("C=54", 2, 8, 28, 28, 54, (1, 1, 1), (0, 0, 0), "mixed"),
    ("C=54 stride 2", 2, 8, 28, 28, 54, (1, 2, 2), (0, 0, 0), "mixed"),
    ("C=108", 2, 8, 14, 14, 108, (1, 1, 1), (0, 0, 0), "mixed"),
    ("C=108 stride 2", 2, 8, 14, 14, 108, (1, 2, 2), (0, 0, 0), "mixed"),
    ("odd extents", 3, 5, 7, 9, 72, (1, 1, 1), (0, 0, 0), "mixed"),
    ("odd extents stride 2", 3, 5, 13, 11, 72, (1, 2, 2), (0, 0, 0),
     "mixed"),
    ("stride (2,2,2) padding (1,1,1)", 2, 8, 14, 14, 144, (2, 2, 2),
     (1, 1, 1), "mixed"),
    ("stride (1,2,2) padding (0,1,0)", 2, 8, 14, 14, 144, (1, 2, 2),
     (0, 1, 0), "mixed"),
    ("one clip", 1, 8, 28, 28, 144, (1, 1, 1), (0, 0, 0), "mixed"),
    ("shifts of +-9", 2, 8, 28, 28, 144, (1, 1, 1), (0, 0, 0), "far"),
    ("shifts of +-9 stride 2", 2, 8, 28, 28, 144, (1, 2, 2), (0, 0, 0),
     "far"),
]
# Tolerances against the plain versions (chip_smoke.py's): the forward and
# the input gradient float32 rel-max 1e-4 (summation order), bfloat16
# rel-L2 1e-2 (the plain version rounds each axis stage); quantized, a
# copy: exact in bfloat16. The shift gradient rel-L2 1e-4 (float32 inputs)
# and 1e-3 (bfloat16 inputs: larger terms that cancel more), both summing
# in f32.
TOL_INV = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TOL_SG = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
KNOBS = ("BWD_SMEM_BUDGET", "BWD_MAX_GROUP", "BWD_MAX_RING",
         "BWD_TARGET_BLOCKS", "BWD_MIN_BAND_ROWS", "BWD_BLOCK_THREADS")
SETTINGS = [
    {},
    {"BWD_TARGET_BLOCKS": 1056, "BWD_MIN_BAND_ROWS": 4},
    {"BWD_TARGET_BLOCKS": 4224},
    {"BWD_BLOCK_THREADS": 192},
    {"BWD_BLOCK_THREADS": 384},
    {},
]


SASS_OPS = ("LDS", "LD.E", "LDG", "STS", "STG", "LDGSTS", "BAR")


def sass_counts(obj):
    """Per kernel of the object file, how many instructions of SASS_OPS
    ``cuobjdump -sass`` lists (static counts, not executed)."""
    cuobjdump = str(Path(_build._find_nvcc()).with_name("cuobjdump"))
    out = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                         text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):  # a predicate
                words = words[1:]
            op = words[0] if words else ""
            for o in SASS_OPS:
                if op == o or op.startswith(o + "."):
                    counts[name][o] += 1
                    break
    return counts


def ptxas_report(sass_out="", parent="") -> None:
    """Registers, spills and shared memory of every kernel of the source (and
    with ``parent`` of that checkout's shift3d_bwd.cu, built against its own
    headers); for this checkout's source also the count of its shared, generic
    and global loads and stores and barriers, and with ``sass_out`` its whole
    SASS listing in that file."""
    sources = [("shift3d_bwd.cu", _build.CSRC / "shift3d_bwd.cu")]
    if parent:
        sources.append(("parent's shift3d_bwd.cu", Path(parent)
                        / "rubiksnet_torch/ops/csrc/shift3d_bwd.cu"))
    for name, path in sources:
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run(
                [_build._find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                 "-c", "-o", f"{tmp}/k.o", str(path)],
                capture_output=True, text=True)
            if name == "shift3d_bwd.cu" and proc.returncode == 0:
                for kernel, ops in sass_counts(f"{tmp}/k.o").items():
                    print(f"  [sass] {kernel[:70]}: " + ", ".join(
                        f"{o} {n}" for o, n in ops.items()))
                if sass_out:
                    cuobjdump = str(Path(_build._find_nvcc()).with_name(
                        "cuobjdump"))
                    Path(sass_out).parent.mkdir(parents=True, exist_ok=True)
                    with open(sass_out, "w") as f:
                        subprocess.run([cuobjdump, "-sass", f"{tmp}/k.o"],
                                       stdout=f, check=True)
                    print(f"  [sass] written to {sass_out}")
        print(f"[ptxas] {name}: nvcc exit {proc.returncode}")
        lines = (proc.stdout + proc.stderr).splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                print("  " + line.split("'")[1][:72], "|",
                      " ".join(lines[i + 1: i + 4]).replace(
                          "ptxas info    :", ""))
        if proc.returncode != 0:
            print(proc.stderr)
            raise RuntimeError("nvcc failed")


def _inputs(h, c, s, batch, gen, dev):
    stride = (1, s, s)
    x = torch.randn((batch, FRAMES, h, h, c), generator=gen,
                    device=dev).to(torch.bfloat16)
    og = torch.randn(s3.compute_output_shape_3d(x.shape, stride, (0, 0, 0)),
                     generator=gen, device=dev).to(torch.bfloat16)
    shift = torch.rand((3, c), generator=gen, device=dev) * 2 - 1
    return stride, x, og, shift


def trace(dev, batch) -> None:
    """When the blocks of one launch reach the stages of their lives (a
    build with BWD3D_TRACE): per shape and kernel the
    launch's span, the blocks per SM, and the median and the largest time
    of each stage."""
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = ("setup", "first row's wait", "rows", "after the rows")
    lib = _build.load_library()
    if not hasattr(lib, "rubiks_bwd3d_trace"):
        raise RuntimeError("the library was built without BWD3D_TRACE")
    lib.rubiks_bwd3d_trace.argtypes = [ctypes.c_void_p]
    lib.rubiks_bwd3d_trace.restype = ctypes.c_int
    for h, c, s, _ in SHAPES:
        stride, x, og, shift = _inputs(h, c, s, batch, gen, dev)
        for name, fn, direction in (
                ("fwd", lambda: s3.shift3d_kernel(x, shift, stride),
                 s3.FORWARD),
                ("inv", lambda: s3.shift3d_input_grad_kernel(
                    og, shift, x.shape, stride), s3.INPUT_GRAD),
                ("sg", lambda: s3.shift3d_shift_grad_kernel(
                    og, x, shift, stride), s3.SHIFT_GRAD)):
            plan = s3.shift3d_bwd_plan(x.shape, og.shape, stride,
                                       torch.bfloat16, direction)
            blocks = plan.units * plan.groups
            buf = torch.zeros((blocks, 8), dtype=torch.int64,
                              device=dev)
            fn()
            torch.cuda.synchronize()
            _build.check(lib.rubiks_bwd3d_trace(buf.data_ptr()),
                         "rubiks_bwd3d_trace")
            fn()
            torch.cuda.synchronize()
            _build.check(lib.rubiks_bwd3d_trace(None),
                         "rubiks_bwd3d_trace")
            raw = buf.cpu()
            seen = raw[:, :5] > 0
            # Nanoseconds from the first block's start (before any float).
            t = torch.where(seen, raw[:, :5] - int(raw[:, 0].min()),
                            0).double()
            end = t[:, 4]
            span = float(end.max()) / 1e3
            life = (end - t[:, 0]) / 1e3
            per_sm = torch.bincount(raw[:, 7]).float()
            wait, comp = raw[:, 5].double(), raw[:, 6].double()
            text = (f"  {h}x{h}x{c} stride {s} {name}: span "
                    f"{span:.1f} us, {blocks} blocks on "
                    f"{int((per_sm > 0).sum())} SMs (at most "
                    f"{int(per_sm.max())} a SM), block life median "
                    f"{float(life.median()):.2f} max "
                    f"{float(life.max()):.2f} us;")
            cols = [(1, 0), (2, 1), (3, 2), (4, 3)]
            for stage, (b, a) in zip(stages, cols):
                ok = seen[:, b] & seen[:, a]
                if ok.any():
                    d = (t[ok, b] - t[ok, a]) / 1e3
                    text += (f" {stage} {float(d.median()):.2f}/"
                             f"{float(d.max()):.2f}")
            print(text + f" (median/max us); thread 0's cycles in the rows: "
                  f"waits and barriers {float(wait.median()):.0f}, compute "
                  f"{float(comp.median()):.0f} (medians)")


def case_shift(kind, c, gen, dev):
    """A (3, C) float32 shift of the given kind."""
    shift = torch.rand((3, c), generator=gen, device=dev) * 3.6 - 1.8
    shift[:, ::4] = shift[:, ::4].round()
    if kind == "far":
        far = 9.0 * (1 - 2 * (torch.arange(8, device=dev) % 2))
        shift[:, :8] = shift[:, :8] / 2 + far
    return shift


def rel_errors(got, ref):
    got, ref = got.float(), ref.float()
    d = got - ref
    return (float(d.abs().max()),
            float(d.abs().max()) / max(float(ref.abs().max()), 1e-30),
            float(d.norm()) / max(float(ref.norm()), 1e-30))


def check_case(x_shape, stride, padding, dt, shift, gen):
    """The three kernels against their plain versions on one shape, each
    run twice: a list of (label, max_abs, measure, value, bound, ok) rows,
    the rerun's equality folded into ok."""
    dev = shift.device
    og_shape = s3.compute_output_shape_3d(x_shape, stride, padding)
    og = torch.randn(og_shape, generator=gen, device=dev).to(dt)
    x = torch.randn(x_shape, generator=gen, device=dev).to(dt)
    rows = []
    for what, kernel, plain in (
            ("forward",
             lambda q: s3.shift3d_kernel(x, shift, stride, padding, q),
             lambda q: s3.shift3d_plain(x, shift, stride, padding, q)),
            ("input grad",
             lambda q: s3.shift3d_input_grad_kernel(og, shift, x_shape,
                                                    stride, padding, q),
             lambda q: s3.shift3d_input_grad_plain(og, shift, x_shape,
                                                   stride, padding, q))):
        for q in (False, True):
            got, again, ref = kernel(q), kernel(q), plain(q)
            max_abs, rel_max, rel_l2 = rel_errors(got, ref)
            if dt == torch.float32:
                measure, value = "rel_max", rel_max
            else:
                measure, value = "rel_l2", rel_l2
            ok = (value <= TOL_INV[dt] and torch.equal(got, again)
                  and bool(torch.isfinite(got).all())
                  and got.shape == ref.shape)
            if q and dt == torch.bfloat16:
                ok = ok and torch.equal(got, ref)
            rows.append((f"{what} {'quantize' if q else 'fractional'}",
                         max_abs, measure, value, TOL_INV[dt], ok))
    got = s3.shift3d_shift_grad_kernel(og, x, shift, stride, padding)
    again = s3.shift3d_shift_grad_kernel(og, x, shift, stride, padding)
    ref = s3.shift3d_shift_grad_plain(og, x, shift, stride, padding)
    max_abs, _, rel_l2 = rel_errors(got, ref)
    ok = (rel_l2 <= TOL_SG[dt] and torch.equal(got, again)
          and got.shape == ref.shape and bool(torch.isfinite(got).all()))
    rows.append(("shift grad", max_abs, "rel_l2", rel_l2, TOL_SG[dt], ok))
    return rows


def check(dev, batch=2) -> bool:
    gen = torch.Generator(device=dev).manual_seed(0)
    todo = [(f"{h}x{h}x{c} stride {s}", batch, FRAMES, h, h, c, (1, s, s),
             (0, 0, 0), "mixed") for h, c, s, _ in SHAPES] + CASES
    ok = True
    for label, n, t, h, w, c, stride, padding, kind in todo:
        for dt in (torch.float32, torch.bfloat16):
            shift = case_shift(kind, c, gen, dev)
            for what, _, measure, value, bound, good in check_case(
                    (n, t, h, w, c), stride, padding, dt, shift, gen):
                ok &= good
                print(f"  {label} {n}x{t}x{h}x{w}x{c} {str(dt)[6:]} {what}: "
                      f"{measure} {value:.2e} [<= {bound:g}], rerun "
                      f"bit-identical {'ok' if good else 'FAIL'}")
    return ok


def device_ms(fn, iters=5):
    """(device ms per call, device kernels per call) by the profiler."""
    times = cuda_kernel_times(fn, iters=iters)
    return (sum(ms for _, ms in times.values()) / iters,
            sum(n for n, _ in times.values()) / iters)


def host_us(fn, calls=2000):
    """Host microseconds per call of ``fn()``: the time to enqueue, no
    synchronisation inside the window."""
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
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn((8, FRAMES, 7, 7, 576), generator=gen, device=dev).to(bf)
    og = torch.randn(x.shape, generator=gen, device=dev).to(bf)
    shift = torch.rand((3, 576), generator=gen, device=dev) * 2 - 1
    for label, fn in (
            ("shift3d_kernel", lambda: s3.shift3d_kernel(x, shift)),
            ("shift3d_input_grad_kernel",
             lambda: s3.shift3d_input_grad_kernel(og, shift, x.shape)),
            ("shift3d_shift_grad_kernel",
             lambda: s3.shift3d_shift_grad_kernel(og, x, shift))):
        print(f"  host {label}: {host_us(fn):.2f} us per call at "
              f"8x8x7x7x576")


def sweep(dev, batch, picked) -> None:
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    defaults = {k: getattr(s3, k) for k in KNOBS}
    totals = {}
    for h, c, s, count in SHAPES:
        stride = (1, s, s)
        x = torch.randn((batch, FRAMES, h, h, c), generator=gen,
                        device=dev).to(bf)
        og = torch.randn(s3.compute_output_shape_3d(x.shape, stride,
                                                    (0, 0, 0)),
                         generator=gen, device=dev).to(bf)
        shift = torch.rand((3, c), generator=gen, device=dev) * 2 - 1
        for i in picked:
            setting = SETTINGS[i]
            for k in KNOBS:
                setattr(s3, k, setting.get(k, defaults[k]))
            s3._bwd_prepare.cache_clear()
            inv = lambda: s3.shift3d_input_grad_kernel(og, shift, x.shape,
                                                       stride)
            sg = lambda: s3.shift3d_shift_grad_kernel(og, x, shift, stride)
            fwd = lambda: s3.shift3d_kernel(x, shift, stride)
            ref_i = s3.shift3d_input_grad_plain(og, shift, x.shape, stride)
            ref_s = s3.shift3d_shift_grad_plain(og, x, shift, stride)
            ref_f = s3.shift3d_plain(x, shift, stride)
            e_i, e_s = rel_errors(inv(), ref_i)[2], rel_errors(sg(), ref_s)[2]
            e_f = rel_errors(fwd(), ref_f)[2]
            if e_i > TOL_INV[bf] or e_s > TOL_SG[bf] or e_f > TOL_INV[bf]:
                raise RuntimeError(f"{setting}: rel_l2 {e_f:.2e} / "
                                   f"{e_i:.2e} / {e_s:.2e}")
            (i_dev, i_n), (s_dev, s_n) = device_ms(inv), device_ms(sg)
            f_dev, f_n = device_ms(fwd)
            t = totals.setdefault(i, [0.0, 0.0, 0.0])
            t[0] += count * i_dev
            t[1] += count * s_dev
            t[2] += count * f_dev
            pf, pi, ps = (s3.shift3d_bwd_plan(x.shape, og.shape, stride, bf,
                                              d) for d in s3.DIRECTIONS)
            print(f"  {h}x{h}x{c} stride {s} {setting or 'defaults'}: fwd "
                  f"device {f_dev:.4f} ms ({f_n:.0f}) [G{pf.group} "
                  f"R{pf.rows} F{pf.frames} D{pf.ring} x{pf.cols}]; inv "
                  f"{i_dev:.4f} ms ({i_n:.0f}) [G{pi.group} "
                  f"R{pi.rows} F{pi.frames} D{pi.ring} x{pi.cols}]; sg "
                  f"{s_dev:.4f} ms ({s_n:.0f}) [G{ps.group} R{ps.rows} "
                  f"F{ps.frames} D{ps.ring} x{ps.cols}]")
    for k in KNOBS:
        setattr(s3, k, defaults[k])
    s3._bwd_prepare.cache_clear()
    print(f"[sweep] summed over one Large forward (K1) or train step (51 "
          f"calls each), batch {batch}, device ms")
    for i, t in totals.items():
        print(f"  {SETTINGS[i] or 'defaults'}: fwd {t[2]:.3f}, inv "
              f"{t[0]:.3f}, sg {t[1]:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--sass", default="",
                    help="with --ptxas: write shift3d_bwd.cu's SASS here")
    ap.add_argument("--parent", default="",
                    help="with --ptxas: also compile the shift3d_bwd.cu of "
                         "the checkout at this root")
    ap.add_argument("--settings", default="",
                    help="comma-separated indices into SETTINGS (default: "
                         "all)")
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("shift3d_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.trace and (args.ptxas or args.check or args.host or args.sweep):
        ap.error("--trace runs alone")
    if args.trace:  # a build of its own (the digest covers the flags)
        _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DBWD3D_TRACE")
    print(f"[device] {nvidia_smi_line()}; torch {torch.__version__}; nvcc "
          f"flags {' '.join(_build.NVCC_FLAGS)}")
    if args.ptxas:
        ptxas_report(args.sass, args.parent)
    if args.check:
        if not check(dev):
            print("shift3d_bwd_probe: a comparison failed", file=sys.stderr)
            return 1
    if args.host:
        host(dev)
    if args.sweep:
        picked = [int(i) for i in args.settings.split(",") if i]
        sweep(dev, args.batch, picked or range(len(SETTINGS)))
    if args.trace:
        trace(dev, args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
