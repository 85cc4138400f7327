#!/usr/bin/env python3
"""Smoke run of the PyTorch port of RubiksNet on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 shift3d, K2 fused_block, K3 fused_entry)
from rubiksnet_torch/ops/csrc, holds each against its plain PyTorch version
at every RubiksNet-Large shape of the main path, checks the whole Large model
(fused executor and unfused module path against the plain model), counts
the kernel launches of one fused and one unfused forward, and times serving
at batch sizes 1, 8 and 32 (bf16, 8 frames, 224x224). Fails (non-zero exit,
no result line) on the first problem, and without a CUDA device.

The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel results as {"kernels": [...]}.
"""

from __future__ import annotations

import json
import sys
import time

import torch

BATCH_CHECK = 2  # clips per kernel / model check
FRAMES, SIZE, CLASSES, MAX_SHIFT = 8, 224, 174, 1
SERVE_BATCHES = (1, 8, 32)
SERVE_ITERS = 10
TIME_BATCH = 8  # clips per kernel timing (bf16)

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
TOL_F32_REL_MAX = 1e-4
TOL_BF16_REL_L2 = 1e-2
TOL_MODEL_F32 = 1e-4
TOL_MODEL_BF16 = 5e-2

# Large at 224x224: stride-1 (H, C, blocks per forward) and entry
# (H, Cin, Cmid) shapes of the main path.
BLOCK_SHAPES = [(112, 72, 1), (56, 72, 2), (28, 144, 7), (14, 288, 35),
                (7, 576, 2)]
ENTRY_SHAPES = [(112, 72, 72), (56, 72, 144), (28, 144, 288),
                (14, 288, 576)]


def fail(msg):
    raise RuntimeError(msg)


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


def random_block(cin, cout, stride, quantize, gen, device):
    from rubiksnet_torch.nn.backbone import RubiksShiftBlock

    blk = RubiksShiftBlock(cin, cout, stride, quantize, generator=gen)
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn2):
            c = bn.weight.numel()
            bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
            bn.bias.copy_(torch.rand(c, generator=gen) * 0.6 - 0.3)
    return randomize_bn(blk, gen).to(device).eval()


def randn(shape, dtype, gen, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from rubiksnet_torch.models.fused_infer import FusedExecutor
    from rubiksnet_torch.models.rubiksnet import create_rubiksnet
    from rubiksnet_torch.ops import _build, launch_counters
    from rubiksnet_torch.ops.fused_block import (
        fused_block_kernel,
        fused_block_plain,
        stack_block_params,
    )
    from rubiksnet_torch.ops.fused_entry import (
        fused_entry_kernel,
        fused_entry_plain,
        stack_entry_params,
    )
    from rubiksnet_torch.ops.shift3d import shift3d_kernel, shift3d_plain
    from rubiksnet_torch.utils import (
        cuda_call_times_ms,
        cuda_time_ms,
        nvidia_smi_line,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 1: device.
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[device] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi name, power.limit: {smi}")

    # Phase 2: build.
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    errs = {"shift3d": [], "fused_block": [], "fused_entry": []}
    dtypes = (torch.float32, torch.bfloat16)

    # Phase 3: each kernel against its plain version at the Large shapes.
    print("[kernels] K1 shift3d vs gather form")
    k1_shapes = [(h, c, 1) for h, c, _ in BLOCK_SHAPES] + [
        (h, cm, 2) for h, _, cm in ENTRY_SHAPES]
    for h, c, s in k1_shapes:
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
                vt, wm = stack_block_params(blocks, dt, MAX_SHIFT, q)
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
    torch.cuda.synchronize()

    # Kernel times at batch TIME_BATCH, bf16, summed over one forward's
    # calls at each shape (blocks per shape from the Large plan).
    print(f"[timing] per call, batch {TIME_BATCH} bf16, {name} ({smi})")
    bf = torch.bfloat16
    times = {k: [0.0, 0.0] for k in errs}

    def timed(kind, label, count, kernel_fn, plain_fn):
        ms = cuda_time_ms(kernel_fn)
        plain_ms = cuda_time_ms(plain_fn)
        times[kind][0] += count * ms
        times[kind][1] += count * plain_ms
        print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(x{count} per forward)")

    for h, c, count in BLOCK_SHAPES:
        x = randn((TIME_BATCH, FRAMES, h, h, c), bf, gen, dev)
        shift = torch.rand((3, c), generator=gen, device=dev) * 2 - 1
        timed("shift3d", f"K1 {h}x{h}x{c} stride 1", count,
              lambda: shift3d_kernel(x, shift),
              lambda: shift3d_plain(x, shift))
        vt, wm = stack_block_params([random_block(c, c, 1, False, cpu_gen,
                                                  dev)], bf, MAX_SHIFT)
        timed("fused_block", f"K2 {h}x{h}x{c} 1 block", count,
              lambda: fused_block_kernel(x, vt, wm, max_shift=MAX_SHIFT),
              lambda: fused_block_plain(x, vt, wm, max_shift=MAX_SHIFT))
    for h, cin, cm in ENTRY_SHAPES:
        xm = randn((TIME_BATCH, FRAMES, h, h, cm), bf, gen, dev)
        shift = torch.rand((3, cm), generator=gen, device=dev) * 2 - 1
        timed("shift3d", f"K1 {h}x{h}x{cm} stride 2", 1,
              lambda: shift3d_kernel(xm, shift, (1, 2, 2)),
              lambda: shift3d_plain(xm, shift, (1, 2, 2)))
        x = randn((TIME_BATCH, FRAMES, h, h, cin), bf, gen, dev)
        params = stack_entry_params(random_block(cin, cm, 2, False, cpu_gen,
                                                 dev), bf, MAX_SHIFT)
        timed("fused_entry", f"K3 {h}x{h}x{cin}->{cm}", 1,
              lambda: fused_entry_kernel(x, params, max_shift=MAX_SHIFT),
              lambda: fused_entry_plain(x, params, max_shift=MAX_SHIFT))
    for k, (ms, pms) in times.items():
        print(f"  {k}: {ms:.3f} ms per forward, plain {pms:.3f} ms")

    # Phase 4: the whole Large model against the plain model.
    print("[model] RubiksNet-Large rubiks3d, random init (seed 0), "
          "BN stats randomized")
    models = {}
    for dt in dtypes:
        m = create_rubiksnet("large", CLASSES, FRAMES, "rubiks3d",
                             max_shift=MAX_SHIFT, dtype=dt,
                             generator=torch.Generator().manual_seed(0))
        models[dt] = randomize_bn(m, torch.Generator().manual_seed(1)).to(dev)
    video = torch.randn((BATCH_CHECK, FRAMES, SIZE, SIZE, 3), generator=gen,
                        device=dev)
    with torch.no_grad():
        for dt, tol in ((torch.float32, TOL_MODEL_F32),
                        (torch.bfloat16, TOL_MODEL_BF16)):
            m = models[dt]
            ref = m(video, plain=True)
            routes = {"fused executor": FusedExecutor(m)(video)}
            if dt == torch.float32:
                routes["unfused forward (K1)"] = m(video)
            for route, got in routes.items():
                if got.shape != (BATCH_CHECK, CLASSES) or not torch.isfinite(
                        got.float()).all():
                    fail(f"{route} {dt}: bad logits {tuple(got.shape)}")
                _, _, rel_l2 = errors(got, ref)
                ok = rel_l2 <= tol
                print(f"  {route} vs plain model, {str(dt)[6:]}: logits "
                      f"rel_l2={rel_l2:.3e} [<= {tol}] "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"{route} {dt} logits outside tolerance")

    # Phase 5: the main path, counted. One batch through the fused
    # executor, then the same batch through the unfused module path.
    model = models[torch.bfloat16]
    executor = FusedExecutor(model)
    batch = torch.randn((TIME_BATCH, FRAMES, SIZE, SIZE, 3), generator=gen,
                        device=dev)
    counters = launch_counters()
    for ctr in counters.values():
        ctr.reset()
    with torch.no_grad():
        fused_logits = executor(batch)
        torch.cuda.synchronize()
        after_fused = {k: c.count for k, c in counters.items()}
        unfused_logits = model(batch)
        torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    print(f"[main path] launches after the fused forward: {after_fused}; "
          f"after the unfused forward too: {launches}")
    want_fused = {"shift3d": 0, "fused_block": 47, "fused_entry": 4}
    if after_fused != want_fused:
        fail(f"fused forward launches {after_fused} != {want_fused}")
    if launches["shift3d"] != 51:
        fail(f"unfused forward launched K1 {launches['shift3d']} times != 51")
    for label, lg in (("fused", fused_logits), ("unfused", unfused_logits)):
        if lg.shape != (TIME_BATCH, CLASSES) or not torch.isfinite(
                lg.float()).all():
            fail(f"main path {label} logits bad: {tuple(lg.shape)}")
    _, _, rel = errors(fused_logits, unfused_logits)
    print(f"  fused vs unfused logits, bf16: rel_l2={rel:.3e}")
    if rel > TOL_MODEL_BF16:
        fail("fused and unfused main-path logits disagree")

    # Phase 6: serving. Each call answers one batch; its device time comes
    # from CUDA events around it (median, min and max of SERVE_ITERS calls).
    print(f"[serve] fused executor, bf16, {FRAMES}x{SIZE}x{SIZE}, "
          f"{name} ({smi})")

    def serve(label, fn, bs):
        ms = sorted(cuda_call_times_ms(fn, iters=SERVE_ITERS, warmup=2))
        med = ms[len(ms) // 2]
        print(f"  {label} batch {bs}: median {med:.3f} ms/batch "
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

    source = {"shift3d": ("rubiksnet_torch/ops/csrc/shift3d.cu",
                          "rubiksnet_tpu/ops/pallas/shift_kernel.py:169"),
              "fused_block": ("rubiksnet_torch/ops/csrc/fused_block.cu",
                              "rubiksnet_tpu/ops/pallas/fused_block.py:455"),
              "fused_entry": ("rubiksnet_torch/ops/csrc/fused_entry.cu",
                              "rubiksnet_tpu/ops/pallas/fused_entry.py:338")}
    kernels = [{"name": k, "route": "cuda", "source": source[k][0],
                "replaces": source[k][1], "launches": launches[k],
                "max_abs_err": max(errs[k]), "ms": times[k][0],
                "plain_ms": times[k][1]} for k in errs]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
