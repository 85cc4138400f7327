"""K2, the fused stride-1 block (ops/csrc/fused_block.cu, fused_block_tc.cu),
alone on the card: what was compiled, a check, the host's share, a sweep of
the plan's knobs and a comparison with another checkout's K2.

    python3 -m rubiksnet_torch.utils.fused_block_probe --ptxas --check
    python3 -m rubiksnet_torch.utils.fused_block_probe --host --sweep \
        --batch 1 8 32 64
    python3 -m rubiksnet_torch.utils.fused_block_probe --se --ptxas --check \
        --sweep
    python3 -m rubiksnet_torch.utils.fused_block_probe --ptxas \
        --parent scratch_build/parent

``--ptxas`` compiles both sources once more with ``-Xptxas -v`` and prints
each kernel's registers, spills and shared memory, and the tensor-core
(HMMA) instructions ``cuobjdump -sass`` finds in the object; with
``--parent DIR`` also DIR's ``fused_block_tc.cu`` and ``fused_entry_tc.cu``
and this checkout's ``fused_entry_tc.cu``, and a table of each launch's
registers and spill bytes, here and there. ``--check`` holds the kernel
against the plain version (float32 and bfloat16, each run repeated
bit-identically) at the five Large shapes for rubiks3d, aq, se and aq+se,
in bfloat16 also at the served batch sizes 1, 8 and 32 (the plan depends on
the batch), and at CASES: widths 54, 108, 216 and 432, one clip, odd
extents, ``max_shift`` 3 with shifts near +-3, quantized, integer and zero
shifts, taps with three non-zero weights per axis, a run of three blocks.
``--host`` times the enqueue of a 35-block run at 14x14x288 (host clock, no
synchronisation): one call per run against one call per block; and the run
itself by events, with and without the overlap of consecutive launches.
``--sweep`` times the ring's settings of each launch (``a_`` or ``b_``
``loaders``, ``stages``, ``warps_m``, ``warps_n``, ``prefetch`` of
``ops/fused_block.py::fused_block_plan``, the other launch on the plan's
own; ``--launch`` picks one) at the five shapes, bfloat16, at each
``--batch``: launch A for rubiks3d and aq, launch B (the same kernel for
both) for rubiks3d; CUDA events around a run of RUN_BLOCKS blocks in one
call, launches overlapped as they are served; every setting's output
equals the plan's own bit for bit (a row's result does not depend on the
plan), and the plan's own is held against the plain version first.
``--parent DIR`` (a checkout of another commit, e.g. the parent unpacked
by ``git archive``) builds DIR's kernel library and, at every
MODEL_SHAPES entry and every ``--batch`` (default 1, 8, 32 and 64), holds
this checkout's K2 (launch modes 0, 1 and 2: rubiks3d and aq) to DIR's
bit for bit, and times both in turns (DIR, here, here, DIR): device ms
a block by ``torch.profiler`` (launches not
overlapped; also per launch, and launch B summed apart) and ms a block by
events around a run (overlapped). Both run the same fold (:func:`make_run`,
``mid`` in the gather's channel order) under this checkout's ring plan;
DIR's entry point is the ring's (17 plan ints).
``--se`` turns ``--ptxas``, ``--check`` and ``--sweep`` to the SE forms:
``--ptxas`` also compiles the gate launch (``se_gate_tc.cu``) and names
each kernel's launch (K2's A with the gate's sums, ``rubiks_tc_kernel<5>``
and ``<6>`` with aq, beside ``<0>``, ``<1>``, ``<2>``), ``--check`` runs
the se and aq+se variants only, ``--sweep`` times K2-SE and K2-AQ-SE
(launch A with the sums, the gate, launch B; a setting's output held
against the plain version, since the gate's sums follow the rows of a
stage). Needs a CUDA card; prints its name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..nn.backbone import BN, RubiksShiftBlock
from ..ops import _build
from ..ops import fused_block as fb
from .benchmark import cuda_kernel_times, cuda_time_ms, nvidia_smi_line

FRAMES = 8
SERVE_BATCHES = (1, 8, 32)  # clips per call of the served and timed points
PARENT_BATCHES = (1, 8, 32, 64)  # --parent's and --sweep's default batches
# Large at 224 px: (H, C, blocks per forward).
MODEL_SHAPES = [(112, 72, 1), (56, 72, 2), (28, 144, 7), (14, 288, 35),
                (7, 576, 2)]
# Blocks per forward of Small (the SE tier) at the same shapes.
SMALL_COUNTS = {112: 1, 56: 2, 28: 3, 14: 5, 7: 2}
VARIANTS = [(False, False), (True, False), (False, True), (True, True)]
# Off the model's shapes: (label, N, T, H, W, C, max_shift, shift kind,
# blocks). Kinds: "frac" U(-0.95 K, 0.95 K); "far" within 0.3 of +-K;
# "integer" integers in [-K, K], every third channel zero; "quantize"
# quantized blocks with shifts that round onto every tap, K + 1 included;
# "wide" tap rows overwritten with three or more non-zero weights per axis.
CASES = [
    ("C=54", 2, 8, 28, 28, 54, 1, "frac", 2),
    ("C=108", 2, 8, 14, 14, 108, 1, "frac", 2),
    ("C=216", 2, 8, 14, 14, 216, 1, "frac", 2),
    ("C=432", 2, 8, 7, 7, 432, 1, "frac", 2),
    ("one clip", 1, 8, 14, 14, 288, 1, "frac", 2),
    ("one clip 7x7", 1, 8, 7, 7, 576, 1, "frac", 2),
    ("odd extents", 3, 3, 5, 9, 72, 1, "frac", 2),
    ("max_shift 3, shifts near +-3", 2, 8, 14, 14, 144, 3, "far", 2),
    ("max_shift 7", 2, 8, 14, 14, 72, 7, "frac", 1),
    ("quantized shifts", 2, 8, 14, 14, 288, 1, "quantize", 2),
    ("integer and zero shifts", 2, 8, 14, 14, 288, 1, "integer", 2),
    ("wide taps", 2, 4, 7, 7, 72, 1, "wide", 2),
    ("a run of 3 blocks", 2, 8, 14, 14, 288, 1, "frac", 3),
]
TOL_F32_REL_MAX = 1e-4  # f32: summation order only
TOL_BF16_REL_L2 = 1e-2  # bf16: the plain version rounds more often
# The SE gate alone, (frames, C) values in (0, 1), against the plain gate of
# the kernel's own mid: both sum the same float32 terms in another order.
TOL_GATE = 1e-5


def rel_errors(got, ref):
    got, ref = got.float(), ref.float()
    d = got - ref
    return (float(d.abs().max()),
            float(d.abs().max()) / max(float(ref.abs().max()), 1e-30),
            float(d.norm()) / max(float(ref.norm()), 1e-30))


def randomize_block(blk, shift, kind, k, cpu_gen):
    """In place: BN scale U(0.5, 1.5), bias U(-0.3, 0.3), mean U(-0.2, 0.2),
    variance U(0.5, 2); ``shift`` (the block's shift parameter) by ``kind``
    for a tap window of ``k``."""
    rnd = lambda *shape: torch.rand(*shape, generator=cpu_gen)
    with torch.no_grad():
        for mod in blk.modules():
            if isinstance(mod, BN):
                n = mod.weight.numel()
                mod.weight.copy_(rnd(n) + 0.5)
                mod.bias.copy_(rnd(n) * 0.6 - 0.3)
                mod.running_mean.copy_(rnd(n) * 0.4 - 0.2)
                mod.running_var.copy_(rnd(n) * 1.5 + 0.5)
        c = shift.shape[1]
        if kind == "far":
            sign = 1.0 - 2.0 * (torch.arange(c) % 2)
            shift.copy_(sign * (k - 0.3 * rnd(shift.shape)))
        elif kind == "integer":
            shift.copy_((rnd(shift.shape) * (2 * k + 1) - k - 0.5).round()
                        .clamp(-k, k))
            shift[:, ::3] = 0.0
        elif kind == "quantize":
            shift.copy_(rnd(shift.shape) * (2 * k + 1.4) - k - 0.45)
        else:
            shift.copy_((rnd(shift.shape) * 2 - 1) * 0.95 * k)


def make_run(c, blocks, aq, se, dtype, max_shift, kind, cpu_gen, dev):
    """(vt, wm, se) of ``blocks`` random stride-1 blocks on ``dev``
    (:func:`randomize_block`), folded as the executor folds them
    (``fused_block.fold_blocks``)."""
    quantize = kind == "quantize"
    k = max_shift
    mods = []
    for _ in range(blocks):
        blk = RubiksShiftBlock(c, c, 1, quantize,
                               "rubiks3d-aq" if aq else "rubiks3d", se,
                               generator=cpu_gen)
        randomize_block(blk, blk.as3.shift if aq else blk.as3.rubiks3d.shift,
                        kind, k, cpu_gen)
        mods.append(blk.to(dev).eval())
    vt, wm, sep = fb.fold_blocks(mods, dtype, k, aq=aq, quantize=quantize,
                                 se=se)
    if kind == "wide":
        # Every tap non-zero: all channels share one offset key, so any
        # order of them is the gather's.
        tn = fb.taps_from_rows(vt.shape[1], 4, aq)
        first = 4 + (tn if aq else 0)  # the aq form keeps its identity T row
        taps = torch.rand(vt[:, first:4 + 3 * tn].shape, generator=cpu_gen)
        vt[:, first:4 + 3 * tn] = (taps / tn).to(dev)
    return vt, wm, sep


def gate_error(scratch, taps, se, max_shift, stride, first_gate):
    """(max |gate - plain gate| of the kernel's own mid, whether the gate
    equals ``first_gate`` bit for bit) of a kernel call that left its mid
    and gate in ``scratch``; the plain gate is ``se_gate`` of the shift of
    mid, sampled at ``stride``."""
    mid = scratch["mid"]
    v = fb.tap_shift(mid.float(), taps, max_shift)[:, :, ::stride, ::stride]
    ref = fb.se_gate(v, se).reshape(scratch["gate"].shape)
    return (float((scratch["gate"] - ref).abs().max()),
            torch.equal(scratch["gate"], first_gate))


def check_case(label, shape, max_shift, kind, blocks, aq, se, dtype, gen,
               cpu_gen, dev, gate_errs=None):
    """One comparison of the kernel with the plain version, the kernel run
    twice; with ``se`` also the last block's gate against the plain gate of
    its mid (appended to ``gate_errs`` where given), bit-identical on the
    rerun. Returns (ok, max_abs, text, the plan the kernel ran under)."""
    vt, wm, sep = make_run(shape[-1], blocks, aq, se, dtype, max_shift, kind,
                           cpu_gen, dev)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    kw = dict(aq=aq, max_shift=max_shift)
    scratch = {}
    got = fb.fused_block_kernel(x, vt, wm, sep, scratch=scratch, **kw)
    first_gate = scratch["gate"].clone() if se else None
    again = fb.fused_block_kernel(x, vt, wm, sep, scratch=scratch, **kw)
    ref = fb.fused_block_plain(x, vt, wm, sep, **kw)
    torch.cuda.synchronize()
    max_abs, rel_max, rel_l2 = rel_errors(got, ref)
    same = torch.equal(got, again)
    finite = bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32:
        ok, what = rel_max <= TOL_F32_REL_MAX, f"rel_max<={TOL_F32_REL_MAX}"
    else:
        ok, what = rel_l2 <= TOL_BF16_REL_L2, f"rel_l2<={TOL_BF16_REL_L2}"
    ok = ok and same and finite and got.shape == ref.shape
    tn = fb.taps_from_rows(vt.shape[1], 4, aq)
    plan = fb.fused_block_plan(shape, dtype, sms=fb._sm_count(dev.index),
                               gate=(tn, max_shift) if se else None)
    tag = f"K2{'-AQ' if aq else ''}{'-SE' if se else ''}"
    text = (f"{tag} {label} {tuple(shape)} {str(dtype)[6:]}: max_abs="
            f"{max_abs:.3e} rel_max={rel_max:.3e} rel_l2={rel_l2:.3e} "
            f"[{what}] rerun {'bit-identical' if same else 'DIFFERS'}")
    if se:
        err, same_gate = gate_error(scratch, vt[-1, 4:4 + 3 * tn], sep[-1],
                                    max_shift, 1, first_gate)
        ok = ok and err <= TOL_GATE and same_gate
        text += (f", gate max_abs={err:.2e} [<={TOL_GATE}] rerun "
                 f"{'bit-identical' if same_gate else 'DIFFERS'}")
        if gate_errs is not None:
            gate_errs.append(err)
    text += f" [{plan.describe()}] {'ok' if ok else 'FAIL'}"
    return ok, max_abs, text, plan


def case_variants(kind):
    """The (aq, se) pairs a case runs under: quantized shifts have no aq
    form."""
    return [v for v in VARIANTS if not (v[0] and kind == "quantize")]


def served_cases(batches=SERVE_BATCHES):
    """The model shapes at the batch sizes that are served and timed: the
    plan depends on the batch (rows per tile, warps, column chunks, tiles per
    block, producer warps), so each is a case of its own."""
    return [(f"{h}x{h}x{c} batch {n}", n, FRAMES, h, h, c, 1, "frac", 2)
            for n in batches for h, c, _ in MODEL_SHAPES]


def check(dev, se_only=False) -> bool:
    gen = torch.Generator(device=dev).manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    ok = True
    both = (torch.float32, torch.bfloat16)
    cases = [((f"{h}x{h}x{c}", 2, FRAMES, h, h, c, 1, "frac", 2), both)
             for h, c, _ in MODEL_SHAPES]
    cases += [(case, both) for case in CASES]
    cases += [(case, (torch.bfloat16,)) for case in served_cases()]
    for (label, n, t, h, w, c, k, kind, blocks), dtypes in cases:
        for dt in dtypes:
            for aq, se in case_variants(kind):
                if se_only and not se:
                    continue
                good, _, text, _ = check_case(label, (n, t, h, w, c), k, kind,
                                              blocks, aq, se, dt, gen,
                                              cpu_gen, dev)
                print("  " + text)
                ok &= good
    return ok


# The launch each tensor-core kernel instantiation is, by its mangled name
# (the mode of csrc/tc_core.cuh::TcMode).
LAUNCH_NAMES = {
    "rubiks_tc_kernelILi0E": "K2 A", "rubiks_tc_kernelILi1E": "K2 A-AQ",
    "rubiks_tc_kernelILi2E": "K2 B", "rubiks_tc_kernelILi5E": "K2 A-SE",
    "rubiks_tc_kernelILi6E": "K2 A-AQ-SE",
    "rubiks_entry_tc_kernelILi3E": "K3 A",
    "rubiks_entry_tc_kernelILi4E": "K3 B",
    "rubiks_entry_tc_kernelILi7E": "K3 A-SE",
    "rubiks_entry_gather_kernel": "K3 gather pre-pass",
    "se_gate_tc_kernel": "the SE gate (tensor-core route)",
}


def launch_name(mangled: str) -> str:
    return next((v for k, v in LAUNCH_NAMES.items() if k in mangled), "")


def ptxas_report(sources=("fused_block_tc.cu", "fused_block.cu"),
                 csrc=_build.CSRC, tag="") -> dict:
    """Registers, spills and shared memory of every kernel of the sources in
    ``csrc``, each tensor-core launch named, and the tensor-core
    instructions in each object. -> {launch name: (registers, spill store
    bytes, spill load bytes)} of the named launches."""
    nvcc = _build._find_nvcc()
    usage = {}
    for name in sources:
        with tempfile.TemporaryDirectory() as tmp:
            obj = f"{tmp}/{name}.o"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                 str(Path(csrc) / name)], capture_output=True, text=True)
            print(f"[ptxas{tag}] {name}: nvcc exit {proc.returncode} in "
                  f"{time.perf_counter() - t0:.1f} s")
            lines = (proc.stdout + proc.stderr).splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry function" in line:
                    mangled = line.split("'")[1]
                    info = " ".join(lines[i + 1: i + 4])
                    print("  " + mangled[:70], f"[{launch_name(mangled)}]",
                          "|", info.replace("ptxas info    :", ""))
                    regs = re.search(r"Used (\d+) registers", info)
                    spill = re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", info)
                    if launch_name(mangled) and regs and spill:
                        usage[launch_name(mangled)] = (
                            int(regs.group(1)), int(spill.group(1)),
                            int(spill.group(2)))
            if proc.returncode != 0:
                print(proc.stderr)
                raise RuntimeError("nvcc failed")
            sass = subprocess.run(
                [str(nvcc).replace("nvcc", "cuobjdump"), "-sass", obj],
                capture_output=True, text=True)
            if sass.returncode == 0:
                hmma = [ln for ln in sass.stdout.splitlines() if "HMMA" in ln]
                kinds = sorted({ln.split("HMMA")[1].split()[0]
                                for ln in hmma})
                print(f"  SASS: {len(hmma)} HMMA instructions {kinds}; "
                      f"{sass.stdout.count('LDSM')} LDSM, "
                      f"{sass.stdout.count('LDGSTS')} LDGSTS (cp.async)")
            else:
                print(f"  cuobjdump failed: {sass.stderr[:200]}")
    return usage


def ptxas_beside(parent) -> None:
    """K2's and K3's tensor-core launches, their registers and spill bytes
    here and in the checkout ``parent``."""
    sources = ("fused_block_tc.cu", "fused_entry_tc.cu")
    here = ptxas_report(sources)
    there = ptxas_report(sources, Path(parent) / "rubiksnet_torch" / "ops"
                         / "csrc", tag=" parent")
    print("[ptxas] launch: registers, spill stores, spill loads (bytes); "
          "here | parent")
    for name in sorted(set(here) | set(there)):
        print(f"  {name}: {here.get(name)} | {there.get(name)}"
              f"{'' if here.get(name) == there.get(name) else ' (differs)'}")


def host_us(fn, calls=8, rounds=5):
    """Host microseconds per call of ``fn()``: the time to enqueue ``calls``
    calls on an idle stream with no synchronisation inside the window (few
    enough that the launch queue never fills), the least of ``rounds``."""
    best = float("inf")
    for _ in range(rounds + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * best / calls


def host(dev) -> None:
    """A 35-block run at 14x14x288, one clip and eight. Host time to
    enqueue it (one clip: the device is then not the limit): one C call per
    run, and one per block as the wrapper made them before. Time per run by
    events: with and without the overlap of consecutive launches
    (programmatic dependent launch)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    vt, wm, _ = make_run(288, 35, False, False, bf, 1, "frac", cpu_gen, dev)
    for batch in (1, 8):
        x = torch.randn((batch, FRAMES, 14, 14, 288), generator=gen,
                        device=dev).to(bf)

        def per_block():
            y = x
            for b in range(vt.shape[0]):
                y = fb.fused_block_kernel(y, vt[b:b + 1], wm[b:b + 1],
                                          max_shift=1)
            return y

        for label, fn in (
                ("one call per run",
                 lambda: fb.fused_block_kernel(x, vt, wm, max_shift=1)),
                ("the same, launches not overlapped",
                 lambda: fb.fused_block_kernel(x, vt, wm, max_shift=1,
                                               overlap=False)),
                ("one call per block", per_block)):
            us = host_us(fn)
            ms = cuda_time_ms(fn, iters=10)
            print(f"  host {label}: {us:.1f} us to enqueue a 35-block run "
                  f"at 14x14x288, {batch} clip(s) ({us / 35:.2f} us a "
                  f"block); {ms:.4f} ms a run by events")


def device_ms(fn, needles, iters=5):
    """(device ms per call of the kernels whose name holds a needle, device
    kernels per call, {short kernel name: ms per call})."""
    times = cuda_kernel_times(fn, iters=iters)
    total = sum(ms for k, (_, ms) in times.items()
                if any(n in k for n in needles))
    by_name = {k.split("(")[0].replace("void rubiks::", "")[:40]: ms / iters
               for k, (_, ms) in sorted(times.items())}
    return total / iters, sum(n for n, _ in times.values()) / iters, by_name


# Kernel names of K2's bfloat16 launches, as the profiler shows them (with
# the SE gate's).
NEEDLES = ("rubiks_tc_kernel", "se_gate_tc_kernel")

RUN_BLOCKS = 6  # blocks of one timed call: the host's enqueue stays hidden


def ring_settings(shape, sms, launch):
    """The sweep's settings of ``launch`` ("a" or "b") at ``shape``: the
    plan's own first, then every (loaders, stages, warps_m, warps_n,
    prefetch) that fits, with warps_n the plan's: the multiplying warps 2
    to 16, the loaders all 16 warps or those that do not multiply, one to
    three stages, the L2 prefetch where a stage holds at most 64 rows. The
    other launch keeps the plan's own."""
    bf = torch.bfloat16
    own = fb.fused_block_plan(shape, bf, sms=sms)
    out, seen = [{}], {own}
    wn = getattr(own, launch).warps_n
    for mults in (2, 4, 8, 16):
        if mults % wn:
            continue
        for loaders in sorted({fb.MAX_WARPS, fb.MAX_WARPS - mults} - {0}):
            for stages in (1, 2, 3):
                for prefetch in (False, True):
                    if prefetch and mults // wn * fb.WARP_ROWS > 64:
                        continue
                    knobs = {f"{launch}_{k}": v for k, v in dict(
                        loaders=loaders, stages=stages, warps_m=mults // wn,
                        warps_n=wn, prefetch=prefetch).items()}
                    try:
                        plan = fb.fused_block_plan(shape, bf, sms=sms,
                                                   **knobs)
                    except ValueError:
                        continue  # more shared memory than a block has
                    if plan not in seen:
                        seen.add(plan)
                        out.append(knobs)
    return out


def events_ms_per_block(fn, blocks, iters=10):
    """ms a block of ``fn()``, a run of ``blocks`` blocks, by events."""
    return cuda_time_ms(fn, iters=iters) / blocks


def sweep(dev, batches, se=False, launches=("a", "b")) -> bool:
    """Times every setting of each launch at each batch, the other launch
    on the plan's own (launch B is the same kernel with and without aq, so
    only rubiks3d sweeps it); a setting's output equals the plan's own bit
    for bit (SE: held against the plain version), the plan's own held
    against the plain version first."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    sms = fb._sm_count(dev.index)
    ok = True
    for batch in batches:
        best = []
        for h, c, count in MODEL_SHAPES:
            count = SMALL_COUNTS[h] if se else count
            shape = (batch, FRAMES, h, h, c)
            x = torch.randn(shape, generator=gen, device=dev).to(bf)
            for aq, launch in ((False, "a"), (True, "a"), (False, "b")):
                if launch not in launches:
                    continue
                tag = (f"K2{'-AQ' if aq else ''}{'-SE' if se else ''} "
                       f"launch {launch.upper()}")
                vt, wm, sep = make_run(c, RUN_BLOCKS, aq, se, bf, 1, "frac",
                                       cpu_gen, dev)
                kw = dict(aq=aq, max_shift=1)
                one = (vt[:1], wm[:1], sep[:1] if se else None)
                own = fb.fused_block_kernel(x, *one, **kw)
                plain = fb.fused_block_plain(x, *one, **kw)
                rel = rel_errors(own, plain)[2]
                if not rel <= TOL_BF16_REL_L2:
                    print(f"  {tag} {h}x{h}x{c} batch {batch}: the plan's "
                          f"own output rel_l2={rel:.3e} against plain FAIL")
                    ok = False
                    continue
                rows = []
                for setting in ring_settings(shape, sms, launch):
                    plan = fb.fused_block_plan(shape, bf, sms=sms, **setting)
                    try:
                        got = fb.fused_block_kernel(x, *one, **kw, **setting)
                    except ValueError:
                        continue  # the gate's sums do not fit beside it
                    same = (rel_errors(got, plain)[2] <= TOL_BF16_REL_L2
                            if se else torch.equal(got, own))
                    if not same:
                        print(f"  {tag} {h}x{h}x{c} batch {batch} {setting} "
                              f"[{plan.describe()}]: output differs FAIL")
                        ok = False
                        continue
                    ms = events_ms_per_block(
                        lambda: fb.fused_block_kernel(
                            x, vt, wm, sep, **kw, **setting), RUN_BLOCKS)
                    rows.append((ms, setting, plan))
                    print(f"  {tag} {h}x{h}x{c} batch {batch} "
                          f"{setting or 'defaults'} "
                          f"[{getattr(plan, launch).describe()}]: {ms:.4f} "
                          f"ms a block")
                if rows:
                    fastest = min(rows, key=lambda r: r[0])
                    best.append((tag, h, c, count, rows[0][0], fastest,
                                 launch))
        print(f"[sweep] batch {batch}: the plan's own against the fastest "
              f"setting of each launch, ms a block of both (blocks of a "
              f"{'Small' if se else 'Large'} forward)")
        for tag, h, c, count, own_ms, (ms, setting, plan), launch in best:
            print(f"  {tag} {h}x{h}x{c} x{count}: own {own_ms:.4f}, fastest "
                  f"{ms:.4f} ({100 * (own_ms / ms - 1):+.1f}%) "
                  f"{setting or 'defaults'} "
                  f"[{getattr(plan, launch).describe()}]")
    return ok


# ------------------------------------------------------------ --parent


def parent_library(parent):
    """DIR's kernel library, built as ops/_build.py builds this checkout's,
    and its K2 entry point as the ring took it: eight pointers, then dtype,
    B, N, T, H, W, C, taps_n, K, aq, Cr, slices, the plan's 17 ints (per
    launch loaders, stages, warps_m, warps_n, n_tiles, grid_x, smem_bytes,
    prefetch; then overlap) and the stream."""
    csrc = Path(parent) / "rubiksnet_torch" / "ops" / "csrc"
    # The two libraries define the same C++ names. DIR's are bound to its
    # own definitions (-Bsymbolic), and its function-local statics kept its
    # own (-fno-gnu-unique): the loader otherwise makes one object of the
    # "shared memory raised" flag of both libraries' launch templates, and
    # DIR's kernels then launch without their shared-memory limit raised.
    lib, _ = _build.build_library(
        "rubiks_parent", _build._find_nvcc(), sorted(csrc.glob("*.cu")),
        sorted(csrc.glob("*.cuh")),
        (*_build.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique"),
        ("-Xlinker", "-Bsymbolic"))
    fn = lib.rubiks_fused_block_run
    fn.argtypes = [_build.PTR] * 8 + [_build.INT] * 12 + [_build.PTR] * 2
    fn.restype = _build.INT
    return fn


def parent_run(fn, x, vt, wm, aq, overlap=True):
    """A run of blocks through DIR's K2 (bfloat16, no gate) under this
    checkout's ring plan."""
    n, t, h, w, c = x.shape
    plan = fb.fused_block_plan(x.shape, x.dtype,
                               sms=fb._sm_count(x.device.index),
                               overlap=overlap)
    ints = (_build.INT * 17)(*plan.a.as_ints()[:8], *plan.b.as_ints()[:8],
                             int(plan.overlap))
    out, mid = torch.empty_like(x), torch.empty_like(x)
    taps_n = fb.taps_from_rows(vt.shape[1], 4, aq)
    rc = fn(x.data_ptr(), vt.data_ptr(), wm.data_ptr(), None, None, None,
            mid.data_ptr(), out.data_ptr(), 1, vt.shape[0], n, t, h, w, c,
            taps_n, 1, int(aq), 0, 0, ints, _build.stream_of(x))
    if rc != 0:
        raise RuntimeError(f"the parent's rubiks_fused_block_run: {rc}")
    return out


def parent_compare(dev, parent, batches) -> bool:
    """K2 here against K2 of the checkout ``parent``: launch modes 0, 1
    and 2 (rubiks3d: A then B; aq: A-AQ then B) bit for bit at every model
    shape and batch, and both timed in turns."""
    fn = parent_library(parent)
    gen = torch.Generator(device=dev).manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    ok = True
    totals = {}
    for batch in batches:
        for h, c, count in MODEL_SHAPES:
            shape = (batch, FRAMES, h, h, c)
            x = torch.randn(shape, generator=gen, device=dev).to(bf)
            for aq in (False, True):
                vt, wm, _ = make_run(c, RUN_BLOCKS, aq, False, bf, 1, "frac",
                                     cpu_gen, dev)
                plan = fb.fused_block_plan(shape, bf,
                                           sms=fb._sm_count(dev.index))
                here = lambda o=True: fb.fused_block_kernel(
                    x, vt, wm, aq=aq, max_shift=1, overlap=o)
                there = lambda o=True: parent_run(fn, x, vt, wm, aq, o)
                a, b = here(), there()
                same = torch.equal(a, b) and torch.equal(here(), a)
                ok &= same
                dev_ms, evt_ms, split = {}, {}, {}
                for side, run in (("parent", there), ("here", here),
                                  ("here", here), ("parent", there)):
                    d, _, by_name = device_ms(lambda: run(False), NEEDLES,
                                              iters=3)
                    e = events_ms_per_block(run, RUN_BLOCKS)
                    dev_ms.setdefault(side, []).append(d / RUN_BLOCKS)
                    evt_ms.setdefault(side, []).append(e)
                    for k, v in by_name.items():
                        split.setdefault((side, k), []).append(v / RUN_BLOCKS)
                d_p, d_h = (sum(dev_ms[k]) / 2 for k in ("parent", "here"))
                e_p, e_h = (sum(evt_ms[k]) / 2 for k in ("parent", "here"))
                launches = ", ".join(
                    f"{side} {k.replace('rubiks_tc_kernel', '')} "
                    f"{sum(v) / len(v):.4f}"
                    for (side, k), v in sorted(split.items()))
                b_p, b_h = (sum(sum(v) / len(v)
                                for (sd, k), v in split.items()
                                if sd == side and k.endswith("<2>"))
                            for side in ("parent", "here"))
                t = totals.setdefault((batch, aq), [0.0] * 6)
                for i, v in enumerate((d_p, d_h, e_p, e_h, b_p, b_h)):
                    t[i] += count * v
                print(f"  K2{'-AQ' if aq else ''} {h}x{h}x{c} batch {batch}:"
                      f" {'bit-identical' if same else 'DIFFERS'}; device ms"
                      f" a block parent {d_p:.4f} here {d_h:.4f} "
                      f"({100 * (d_h / d_p - 1):+.1f}%), events {e_p:.4f} "
                      f"{e_h:.4f} ({100 * (e_h / e_p - 1):+.1f}%); launch B "
                      f"{b_p:.4f} {b_h:.4f} ({100 * (b_h / b_p - 1):+.1f}%);"
                      f" by launch {launches} [here {plan.describe()}]")
    print("[parent] summed over the 47 blocks of a Large forward: device "
          "ms parent, here; events ms parent, here; launch B device ms "
          "parent, here")
    for (batch, aq), (d_p, d_h, e_p, e_h, b_p, b_h) in sorted(
            totals.items()):
        print(f"  K2{'-AQ' if aq else ''} batch {batch}: {d_p:.3f}, {d_h:.3f}"
              f" ({100 * (d_h / d_p - 1):+.1f}%); {e_p:.3f}, {e_h:.3f} "
              f"({100 * (e_h / e_p - 1):+.1f}%); {b_p:.3f}, {b_h:.3f} "
              f"({100 * (b_h / b_p - 1):+.1f}%)")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--batch", type=int, nargs="+", default=None)
    ap.add_argument("--se", action="store_true")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--launch", nargs="+", choices=("a", "b"),
                    default=("a", "b"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_block_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    batches = args.batch or PARENT_BATCHES
    print(f"[device] {nvidia_smi_line()}; torch {torch.__version__}")
    if args.ptxas and args.parent:
        ptxas_beside(args.parent)
    elif args.ptxas:
        ptxas_report(("fused_block_tc.cu", "fused_block.cu")
                     + (("se_gate_tc.cu",) if args.se else ()))
    if args.check:
        if not check(dev, args.se):
            print("fused_block_probe: a comparison failed", file=sys.stderr)
            return 1
    if args.host:
        host(dev)
    if args.parent:
        if not parent_compare(dev, args.parent, batches):
            print("fused_block_probe: K2 differs from the parent's",
                  file=sys.stderr)
            return 1
    if args.sweep:
        if not sweep(dev, batches, args.se, args.launch):
            print("fused_block_probe: a swept setting disagrees",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
