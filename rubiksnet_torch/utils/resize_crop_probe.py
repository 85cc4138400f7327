"""The device loader's ``resize_crop_u8`` (data/csrc/device_loader.cu) on
the card: registers, a check against plain, times, and a sweep of the
launch plan's knobs.

    python3 -m rubiksnet_torch.utils.resize_crop_probe --ptxas --check \
        --time --sweep --phases

``--ptxas`` compiles the source once more with ``-Xptxas -v`` and prints
each kernel's registers, spills and shared memory. ``--check`` holds both
routes (``staged``, the default, and ``previous``) to
``plain_resize_crop`` bit for bit: frames of six sizes in one batch (no
resize, upscales, a portrait frame, downscales of ksize 5 and 7), 1 and 3
crops, groups of 1 and 4, a buffer whose rows start off 16 bytes and an
output that does not, and the three shapes of ``SHAPES``; each twice,
bit-identically. ``--time`` times, at each of ``SHAPES``, the staged
kernel, the previous route and the library's version (``F.interpolate``
with ``antialias=True`` and the crop, or the sliced copy): device ms of
the launch alone (``resize_crop_launch``) by ``torch.profiler``, ms by
CUDA events around the wrapper's calls (its host work included), the
host's ms a call, and the bound
(``utils/roofline.py``). ``--sweep`` times the staged kernel under several
settings of ``BAND_ROWS``, ``RUN_BANDS``, ``THREADS``, ``COPY_ROWS``,
``COPY_THREADS`` and ``SMEM_BUDGET`` of
``data/device_loader.py::resize_crop_plan``, each first held against
plain. ``--phases`` says where the staged kernel's time goes: it builds
copies of the source with a phase's work taken out (the horizontal taps,
the vertical taps, both, everything after the taps are staged) and times
each beside the whole kernel at the resized shapes (a copy's output is
wrong by design; it is timed, not checked). Needs a CUDA card (raises
elsewhere); prints its name and power limit.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data import device_loader as dl
from .benchmark import cuda_kernel_times, cuda_time_ms, nvidia_smi_line
from .roofline import resize_crop_bound_ms, resize_crop_work

SCALE, CROP = 256, 224
# (label, width, height, frames, crops a frame, group): the evaluator's
# 1-clip batch (32 videos x 8 frames, the centre crop) of its 340x256
# frames (only cropped) and of the raw 427x240 ones (resized to 455x256),
# and its 2-clip batch of 427x240 (8 videos x 2 clips x 8 frames, 3 crops).
SHAPES = (("copy 340x256", 340, 256, 256, 1, 8),
          ("resize 427x240", 427, 240, 256, 1, 8),
          ("2-clip 427x240", 427, 240, 128, 3, 16))
# Frames of --check: (width, height), as chip_smoke.py's LOADER_FRAMES.
CHECK_FRAMES = ((340, 256), (427, 240), (240, 320), (200, 150), (480, 360),
                (1280, 720))
KNOBS = ("BAND_ROWS", "RUN_BANDS", "THREADS", "COPY_ROWS", "COPY_THREADS",
         "SMEM_BUDGET")
SETTINGS = [{}, {"RUN_BANDS": 1}, {"RUN_BANDS": 2}, {"RUN_BANDS": 4},
            {"RUN_BANDS": 14}, {"BAND_ROWS": 8}, {"BAND_ROWS": 8,
                                                  "RUN_BANDS": 14},
            {"BAND_ROWS": 12}, {"BAND_ROWS": 24, "SMEM_BUDGET": 227 * 1024},
            {"THREADS": 128}, {"THREADS": 256}, {"THREADS": 256,
                                                 "RUN_BANDS": 14},
            {"COPY_ROWS": 8}, {"COPY_ROWS": 32}, {"COPY_ROWS": 64},
            {"COPY_THREADS": 64}, {"COPY_THREADS": 256},
            {"COPY_THREADS": 64, "COPY_ROWS": 32}, {}]


def batch(dev, w, h, frames, crops, seed=0):
    """(rgb, sizes, origins) of ``frames`` random w x h frames packed as
    the decoder packs them, the protocol's crops."""
    from ..data.native_eval import center_offset, full_res_offsets

    rng = np.random.RandomState(seed)
    pix = rng.randint(0, 256, (frames, h, w, 3)).astype(np.uint8)
    rgb, sizes = dl.pack_frames(list(pix), dev)
    rw, rh = dl.resized_size(w, h, SCALE)
    one = (full_res_offsets(rw, rh, CROP) if crops == 3
           else [center_offset(rw, rh, CROP)])
    return rgb, sizes, [one] * frames


def library_version(rgb, sizes, origins):
    """One PyTorch call's version of the batch (frames of one size): the
    frames as a strided view; resized by ``F.interpolate`` (bilinear,
    ``antialias=True``: PIL's triangle filter, float32, the whole frame),
    each crop cut, rounded and cast; or the sliced copy."""
    n = len(sizes)
    w, h = (int(v) for v in sizes[0, :2])
    step = int(sizes[1, 2] - sizes[0, 2]) if n > 1 else w * h * 3
    src = rgb.as_strided((n, h, w, 3), (step, w * 3, 3, 1))
    rw, rh = dl.resized_size(w, h, SCALE)
    crops = [tuple(c) for c in origins[0]]
    if not dl.resizes(w, h, SCALE):
        return lambda: torch.cat([src[:, y:y + CROP, x:x + CROP]
                                  for x, y in crops]).contiguous()

    def library():
        x = F.interpolate(src.permute(0, 3, 1, 2).float(), size=(rh, rw),
                          mode="bilinear", antialias=True,
                          align_corners=False)
        x = torch.cat([x[:, :, y:y + CROP, x0:x0 + CROP]
                       for x0, y in crops])
        return x.round().clamp(0, 255).to(torch.uint8).permute(
            0, 2, 3, 1).contiguous()

    return library


def device_ms(fn, needle="resize_crop_u8", iters=10):
    """(device ms a call of the kernels whose name holds ``needle``, device
    records a call), by torch.profiler."""
    times = cuda_kernel_times(fn, iters=iters)
    total = sum(ms for k, (_, ms) in times.items() if needle in k)
    return total / iters, sum(n for n, _ in times.values()) / iters


def host_ms(fn, calls=50):
    """The host's ms a call (median): the wrapper's work up to the launch,
    each call after the device is idle."""
    fn()
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(out)


def ptxas_report() -> None:
    from ..ops._build import NVCC_FLAGS, _find_nvcc

    inc = [f for f in dl._link_flags() if f.startswith("-I")]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_find_nvcc(), *NVCC_FLAGS, *dl.LOADER_FLAGS, *inc, "-Xptxas",
             "-v", "-c", "-o", f"{tmp}/device_loader.o", str(dl.SOURCE)],
            capture_output=True, text=True)
    print(f"[ptxas] nvcc exit {proc.returncode}")
    lines = (proc.stdout + proc.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            print("  " + line.split("'")[1][:70], "|",
                  " ".join(lines[i + 1: i + 4]).replace("ptxas info    :", ""))
    if proc.returncode != 0:
        print(proc.stderr)
        raise RuntimeError("nvcc failed")


def same_twice(label, rgb, sizes, origins, group, out_lead=0) -> bool:
    """Both routes against plain, each twice; prints one line a route."""
    n, k = len(sizes), len(origins[0])
    ref = dl.plain_resize_crop(rgb, sizes, SCALE, CROP, origins, group)
    ok = True
    for route in dl.ROUTES:
        outs = []
        for _ in range(2):
            out = None
            if out_lead:
                out = torch.empty(n * k * CROP * CROP * 3 + out_lead,
                                  dtype=torch.uint8, device=rgb.device)[
                    out_lead:].view(n * k, CROP, CROP, 3)
            outs.append(dl.resize_crop(rgb, sizes, SCALE, CROP, origins,
                                       group, out=out, route=route).clone())
        torch.cuda.synchronize()
        good = torch.equal(outs[0], ref) and torch.equal(outs[1], outs[0])
        worst = int((outs[0].int() - ref.int()).abs().max())
        print(f"  {label}, route {route}: max |diff| {worst}, "
              f"{'bit-identical, twice' if good else 'DIFFER'}")
        ok &= good
    return ok


def check(dev) -> bool:
    rng = np.random.RandomState(5)
    frames = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
              for w, h in CHECK_FRAMES for _ in range(4)]
    rgb, sizes = dl.pack_frames(frames, dev)
    ok = True
    from ..data.native_eval import center_offset, full_res_offsets

    for crops in (1, 3):
        origins = []
        for w, h, _ in sizes.tolist():
            rw, rh = dl.resized_size(w, h, SCALE)
            origins.append(full_res_offsets(rw, rh, CROP) if crops == 3
                           else [center_offset(rw, rh, CROP)])
        for group in (1, 4):
            ok &= same_twice(f"{len(frames)} frames of "
                             f"{len(CHECK_FRAMES)} sizes, {crops} crop(s), "
                             f"group {group}", rgb, sizes, origins, group)
    lead_rgb = torch.cat([torch.zeros(5, dtype=torch.uint8, device=dev),
                          rgb])[5:]
    ok &= same_twice("the same, rows off 16 bytes by 5, output off by 3",
                     lead_rgb, sizes, origins, 4, out_lead=3)
    for label, w, h, frames_, crops, group in SHAPES:
        rgb_s, sizes_s, origins_s = batch(dev, w, h, frames_, crops)
        ok &= same_twice(label, rgb_s, sizes_s, origins_s, group)
    return ok


def time_shapes(dev) -> None:
    name = torch.cuda.get_device_name(0)
    for label, w, h, frames, crops, group in SHAPES:
        rgb, sizes, origins = batch(dev, w, h, frames, crops)
        tb, to = resize_crop_bound_ms(resize_crop_work(sizes, SCALE, CROP,
                                                       origins))
        bound = max(tb, to)
        lib = library_version(rgb, sizes, origins)
        row = []
        for route in dl.ROUTES:
            fn = (lambda r=route: dl.resize_crop(rgb, sizes, SCALE, CROP,
                                                 origins, group, route=r))
            launch, _ = dl.resize_crop_launch(rgb, sizes, SCALE, CROP,
                                              origins, group, route=route)
            dev_ms, records = device_ms(launch)
            row.append(f"{route}: device {dev_ms:.4f} ms ({records:g} "
                       f"records a launch; {bound / dev_ms:.1%} of the "
                       f"bound), the wrapper by events "
                       f"{cuda_time_ms(fn, iters=20):.4f} ms, its host "
                       f"{host_ms(fn):.4f} ms")
        lib_dev, lib_n = device_ms(lib, needle="")
        row.append(f"library: device {lib_dev:.4f} ms ({lib_n:g} records), "
                   f"events {cuda_time_ms(lib, iters=20):.4f} ms")
        plan = dl.resize_crop_plan(
            CROP, () if not dl.resizes(w, h, SCALE) else
            (((w, dl.resized_size(w, h, SCALE)[0]),
              (h, dl.resized_size(w, h, SCALE)[1])),))
        print(f"[time] {label}, {frames} frames x {crops} crop(s), group "
              f"{group}, scale {SCALE}, crop {CROP}; bound {bound:.4f} ms "
              f"({'bytes' if tb >= to else 'operations'}; bytes {tb:.4f}, "
              f"float64 operations {to:.4f}); plan rows {plan.rows} run "
              f"{plan.run} tile {plan.tile} threads {plan.threads} smem "
              f"{plan.smem} "
              f"({name})")
        for line in row:
            print(f"  {line}")


def sweep(dev) -> None:
    defaults = {k: getattr(dl, k) for k in KNOBS}
    try:
        for label, w, h, frames, crops, group in SHAPES:
            rgb, sizes, origins = batch(dev, w, h, frames, crops)
            ref = dl.plain_resize_crop(rgb, sizes, SCALE, CROP, origins,
                                       group)
            for setting in SETTINGS:
                for k in KNOBS:
                    setattr(dl, k, setting.get(k, defaults[k]))
                launch, out = dl.resize_crop_launch(rgb, sizes, SCALE, CROP,
                                                    origins, group)
                launch()
                if not torch.equal(out, ref):
                    raise RuntimeError(f"{label} {setting}: differs from "
                                       f"plain")
                ms, _ = device_ms(launch)
                print(f"  [sweep] {label} {setting or 'defaults'}: device "
                      f"{ms:.4f} ms")
    finally:
        for k in KNOBS:
            setattr(dl, k, defaults[k])


# --phases: (label, [(text of device_loader.cu, its replacement)]).
PHASES = (
    ("whole kernel", []),
    ("no horizontal taps", [("const int2 t = ct[it.c];",
                             "const int2 t = make_int2(c0, 0);")]),
    ("no vertical taps", [("const int2 t = rt[yb + it.r];",
                           "const int2 t = make_int2(q0, 0);")]),
    ("neither", [("const int2 t = ct[it.c];",
                  "const int2 t = make_int2(c0, 0);"),
                 ("const int2 t = rt[yb + it.r];",
                  "const int2 t = make_int2(q0, 0);")]),
    ("taps staged, then exit", [("  // Both axes' first taps and ends grow",
                                 "  if (yrows > 0) return;\n"
                                 "  // Both axes' first taps and ends grow")]),
)


def phases(dev) -> None:
    """Time copies of the staged kernel with a phase taken out (PHASES),
    built in parallel into a temporary directory, each called through its
    C entry on the wrapper's own inputs."""
    import ctypes

    from ..ops._build import NVCC_FLAGS, _find_nvcc, stream_of

    source = dl.SOURCE.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for j, (_, subs) in enumerate(PHASES):
            text = source
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"--phases: {old!r} not in the source")
                text = text.replace(old, new)
            cu = f"{tmp}/v{j}.cu"
            with open(cu, "w") as f:
                f.write(text)
            procs.append(subprocess.Popen(
                [_find_nvcc(), *NVCC_FLAGS, *dl.LOADER_FLAGS, "-shared",
                 "-o", f"{tmp}/v{j}.so", cu, *dl._link_flags()],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        libs = []
        for proc in procs:
            _, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"--phases: nvcc failed:\n{err}")
        for j in range(len(PHASES)):
            lib = ctypes.CDLL(f"{tmp}/v{j}.so")
            fn = lib.rdl_resize_crop_staged
            fn.argtypes = dl._SIGNATURES["rdl_resize_crop_staged"]
            fn.restype = ctypes.c_int
            libs.append(fn)
        for label, w, h, frames, crops, group in SHAPES[1:]:
            rgb, sizes, origins = batch(dev, w, h, frames, crops)
            sizes, resized, origins, k, group = dl.frame_geometry(
                sizes, SCALE, CROP, origins, group)
            n = len(sizes)
            buf, at, axes = dl.staged_tables(sizes, resized, origins, SCALE,
                                             dev)
            plan = dl.resize_crop_plan(CROP, axes)
            ints = (ctypes.c_int * len(plan))(*plan)
            tables = dl.to_device(buf, dev)
            out = torch.empty((n * k, CROP, CROP, 3), dtype=torch.uint8,
                              device=dev)
            row = []
            for (name, _), fn in zip(PHASES, libs):
                def call(fn=fn):
                    code = fn(rgb.data_ptr(), tables.data_ptr(),
                              tables.data_ptr() + at, n, k, group, CROP,
                              ints, len(ints), out.data_ptr(),
                              stream_of(rgb))
                    if code:
                        raise RuntimeError(f"--phases {name}: error {code}")
                ms, _ = device_ms(call)
                row.append(f"{name} {ms:.4f}")
            print(f"[phases] {label}, device ms: " + ", ".join(row))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("resize_crop_probe: no CUDA device")
    dev = torch.device("cuda", 0)
    print(f"[device] {nvidia_smi_line()}; torch {torch.__version__}")
    if args.ptxas:
        ptxas_report()
    if args.check and not check(dev):
        print("resize_crop_probe: a comparison failed", file=sys.stderr)
        return 1
    if args.time:
        time_shapes(dev)
    if args.sweep:
        sweep(dev)
    if args.phases:
        phases(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
