"""K3, the stride-2 entry block (ops/csrc/fused_entry.cu, fused_entry_tc.cu),
alone on the card: what was compiled, a check, the host's share and a sweep
of the plan's knobs.

    python3 -m rubiksnet_torch.utils.fused_entry_probe --ptxas --check
    python3 -m rubiksnet_torch.utils.fused_entry_probe --host --sweep
    python3 -m rubiksnet_torch.utils.fused_entry_probe --se --ptxas --check \
        --sweep
    python3 -m rubiksnet_torch.utils.fused_entry_probe --aq --check --sweep

``--ptxas`` compiles K2's and K3's sources once more with ``-Xptxas -v``
and prints each kernel's registers, spills and shared memory, and the
tensor-core (HMMA) instructions of each object
(``fused_block_probe.ptxas_report``). ``--check`` holds K3 and K3-SE against
the plain version, each run repeated bit-identically: bf16 on the tensor
cores at the four Large entry shapes at batch 1, 8 and 32 (the plan depends
on the batch), f32 on the SIMT route and bf16 at batch 2, and at CASES
(Cin 54 -> 108, ``max_shift`` 3 with shifts near +-3, quantized,
integer and zero shifts, one clip, non-square even H x W, taps with three
weights per axis); then, by the profiler's kernel names, that bf16 runs
``rubiks_entry_tc_kernel`` and f32 ``gemm_kernel``. ``--host`` times the
enqueue of one entry call (one clip, host clock).
``--sweep`` times one entry, bfloat16 at batch 8 (or ``--batch``), at the four
shapes under pinned ``producers``, ``warps_m``, ``warps_n`` of either launch:
device time of launch A and launch B by ``torch.profiler``, with the launches
not overlapped, beside the plan's own choice; every setting is held against the
plain version before it is timed. ``--se`` turns the three to the SE forms:
``--ptxas`` also compiles the gate launch (``se_gate_tc.cu``; launch A with the
gate's sums is ``rubiks_entry_tc_kernel<7>``, beside the unchanged ``<3>`` and
``<4>``),
``--check`` runs K3-SE only, ``--sweep`` times K3-SE (launch A with the
sums, the gate, the pre-pass, launch B). ``--aq`` turns ``--check`` and
``--sweep`` to K3-AQ, the rubiks3d-aq entry (launch A with the attention
mix is ``rubiks_entry_tc_kernel<8>``; the shift is 2D, an identity T row):
``--check`` at the four entry shapes (Large-AQ's) at batch 2 and 8 in f32
and bf16, at the served batches, and at the CASES the
2D shift can take (no quantized shift); the sweep holds each setting
against the plain version with the mix and beside the module path (the
block's own forward: bn1, the attention shift, the 1x1 convs, the 2D shift
kernel). Needs a CUDA card; prints its name and power limit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..nn.backbone import RubiksShiftBlock
from ..ops import fused_entry as fe
from ..ops.fused_block import _sm_count, stack_se_params, taps_from_rows
from . import fused_block_probe as k2
from .benchmark import cuda_kernel_times, cuda_time_ms, nvidia_smi_line

FRAMES = 8
SERVE_BATCHES = (1, 8, 32)
# Large at 224 px: the entry blocks as (input H, Cin, Cm).
ENTRY_SHAPES = [(112, 72, 72), (56, 72, 144), (28, 144, 288), (14, 288, 576)]
# Off the model's shapes: (label, N, T, H, W, Cin, Cm, max_shift, shift
# kind), the kinds of fused_block_probe.randomize_block and "wide" (tap rows
# overwritten with three or more non-zero weights per axis).
CASES = [
    ("Cin 54 -> 108", 2, 8, 28, 28, 54, 108, 1, "frac"),
    ("max_shift 3, shifts near +-3", 2, 8, 28, 28, 72, 144, 3, "far"),
    ("quantized shifts", 2, 8, 28, 28, 144, 288, 1, "quantize"),
    ("integer and zero shifts", 2, 8, 14, 14, 288, 576, 1, "integer"),
    ("one clip", 1, 8, 14, 14, 288, 576, 1, "frac"),
    ("one clip 112x112", 1, 8, 112, 112, 72, 72, 1, "frac"),
    ("non-square 14x22", 2, 8, 14, 22, 144, 288, 1, "frac"),
    ("non-square 30x8, 3 frames", 3, 3, 30, 8, 72, 144, 1, "frac"),
    ("wide taps", 2, 4, 14, 14, 72, 144, 1, "wide"),
]


def launch_of(name: str) -> str | None:
    """Which part of K3 a device kernel of the profiler is: "A" and "B" (the
    tensor-core launches, rubiks_entry_tc_kernel<3> or, with the gate's
    sums, <7>, or with the attention mix <8>, and <4>), "G" (launch B's
    gather pre-pass), "gate" (the SE
    gate: one launch on the tensor-core route, two on the SIMT route) or
    "simt" (float32's GEMM)."""
    if "rubiks_entry_gather_kernel" in name:
        return "G"
    at = name.find("rubiks_entry_tc_kernel")
    if at >= 0:
        mode = name[at:at + 32]
        return "A" if any(m in mode for m in ("3>", "7>", "8>")) else "B"
    if any(k in name for k in ("se_partial_kernel", "se_gate_kernel",
                               "se_gate_tc_kernel")):
        return "gate"
    return "simt" if "gemm_kernel" in name else None


def make_block(cin, cm, se, max_shift, kind, cpu_gen, dev, aq=False):
    """One random stride-2 entry block on ``dev``, in eval mode; ``aq``: the
    rubiks3d-aq form (attention shift, 2D shift)."""
    quantize = kind == "quantize"
    blk = RubiksShiftBlock(cin, cm, 2, quantize,
                           "rubiks3d-aq" if aq else "rubiks3d", se,
                           generator=cpu_gen)
    k2.randomize_block(blk, blk.as3.shift if aq else blk.as3.rubiks3d.shift,
                       kind, max_shift, cpu_gen)
    return blk.to(dev).eval()


def make_entry(cin, cm, se, dtype, max_shift, kind, cpu_gen, dev, aq=False):
    """(params, se) of one random stride-2 entry block on ``dev``."""
    blk = make_block(cin, cm, se, max_shift, kind, cpu_gen, dev, aq)
    params = (fe.stack_entry_params_aq(blk, dtype, max_shift) if aq else
              fe.stack_entry_params(blk, dtype, max_shift,
                                    kind == "quantize"))
    if kind == "wide":
        vt2 = params[1]
        tn = taps_from_rows(vt2.shape[0], 2)
        taps = torch.rand(vt2[2:].shape, generator=cpu_gen)
        vt2[2:] = (taps / tn).to(dev)
    return params, (stack_se_params([blk])[0] if se else None)


def check_case(label, shape, cm, max_shift, kind, se, dtype, gen, cpu_gen,
               dev, gate_errs=None, aq=False):
    """One comparison of K3 with the plain version, the kernel run twice;
    with ``se`` also the gate against the plain gate of the kernel's mid
    (appended to ``gate_errs`` where given), bit-identical on the rerun;
    ``aq``: K3-AQ. Returns (ok, max_abs, text, the plan the kernel ran
    under)."""
    params, sep = make_entry(shape[-1], cm, se, dtype, max_shift, kind,
                             cpu_gen, dev, aq)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    kw = dict(max_shift=max_shift, aq=aq)
    scratch = {}
    got = fe.fused_entry_kernel(x, params, sep, scratch=scratch, **kw)
    first_gate = scratch["gate"].clone() if se else None
    again = fe.fused_entry_kernel(x, params, sep, scratch=scratch, **kw)
    ref = fe.fused_entry_plain(x, params, sep, **kw)
    torch.cuda.synchronize()
    max_abs, rel_max, rel_l2 = k2.rel_errors(got, ref)
    same = torch.equal(got, again)
    finite = bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32:
        ok, what = (rel_max <= k2.TOL_F32_REL_MAX,
                    f"rel_max<={k2.TOL_F32_REL_MAX}")
    else:
        ok, what = (rel_l2 <= k2.TOL_BF16_REL_L2,
                    f"rel_l2<={k2.TOL_BF16_REL_L2}")
    ok = ok and same and finite and got.shape == ref.shape
    plan = fe.fused_entry_plan(shape, cm, dtype, sms=_sm_count(dev.index))
    text = (f"K3{'-SE' if se else ''}{'-AQ' if aq else ''} {label} "
            f"{tuple(shape)}->{cm} "
            f"{str(dtype)[6:]}: max_abs={max_abs:.3e} rel_max={rel_max:.3e} "
            f"rel_l2={rel_l2:.3e} [{what}] rerun "
            f"{'bit-identical' if same else 'DIFFERS'}")
    if se:
        err, same_gate = k2.gate_error(scratch, params[1][2:], sep,
                                       max_shift, 2, first_gate)
        ok = ok and err <= k2.TOL_GATE and same_gate
        text += (f", gate max_abs={err:.2e} [<={k2.TOL_GATE}] rerun "
                 f"{'bit-identical' if same_gate else 'DIFFERS'}")
        if gate_errs is not None:
            gate_errs.append(err)
    text += f" [{plan.describe()}] {'ok' if ok else 'FAIL'}"
    return ok, max_abs, text, plan


def served_cases(batches=SERVE_BATCHES):
    """The entry shapes at the batch sizes that are served and timed, as
    CASES rows: the plan depends on the batch."""
    return [(f"{h}x{h}x{cin} batch {n}", n, FRAMES, h, h, cin, cm, 1, "frac")
            for n in batches for h, cin, cm in ENTRY_SHAPES]


def model_cases():
    """The entry shapes at batch 2, the check size of chip_smoke.py."""
    return [(f"{h}x{h}x{cin}", 2, FRAMES, h, h, cin, cm, 1, "frac")
            for h, cin, cm in ENTRY_SHAPES]


def aq_cases():
    """K3-AQ's checks besides the served batches: the four entry shapes at
    batch 2 and 8, and the CASES the 2D shift can take (a quantized one has
    no tap form)."""
    return (model_cases() + served_cases((8,))
            + [case for case in CASES if case[-1] != "quantize"])


def route_kernels(gen, cpu_gen, dev, aq=False):
    """By the profiler's kernel names: a bf16 call (with the gate; ``aq``:
    with the attention mix, launch A <8>) runs the tensor-core kernels and
    no SIMT GEMM, an f32 call the SIMT GEMM and no tensor-core kernel.
    Returns (ok, text)."""
    ok, texts = True, []
    tc = "rubiks_entry_tc_kernel<8>" if aq else "rubiks_entry_tc_kernel"
    for dt, want, never in ((torch.bfloat16, tc, "gemm_kernel"),
                            (torch.float32, "gemm_kernel", "rubiks_entry")):
        params, sep = make_entry(288, 576, not aq, dt, 1, "frac", cpu_gen,
                                 dev, aq)
        x = torch.randn((2, FRAMES, 14, 14, 288), generator=gen,
                        device=dev).to(dt)
        times = cuda_kernel_times(lambda: fe.fused_entry_kernel(
            x, params, sep, max_shift=1, aq=aq), iters=3)
        names = sorted(times)
        texts.append(f"K3-{'AQ' if aq else 'SE'} 14x14x288->576 "
                     f"{str(dt)[6:]}, device kernels "
                     f"by the profiler: " + "; ".join(
                         f"{nm[:60]} x{times[nm][0] / 3:g}" for nm in names))
        ok &= (any(want in nm for nm in names)
               and not any(never in nm for nm in names))
    return ok, "\n  ".join(texts)


def check(dev, se_only=False, aq=False) -> bool:
    gen = torch.Generator(device=dev).manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    ok = True
    bf, f32 = torch.bfloat16, torch.float32
    cases = aq_cases() if aq else model_cases() + CASES
    runs = [(case, f32) for case in cases]
    runs += [(case, bf) for case in cases + served_cases()]
    forms = (False,) if aq else (True,) if se_only else (False, True)
    for (label, n, t, h, w, cin, cm, k, kind), dt in runs:
        for se in forms:
            good, _, text, _ = check_case(label, (n, t, h, w, cin), cm, k,
                                          kind, se, dt, gen, cpu_gen, dev,
                                          aq=aq)
            print("  " + text)
            ok &= good
    good, text = route_kernels(gen, cpu_gen, dev, aq)
    print(f"  {text} {'ok' if good else 'FAIL'}")
    return ok and good


def host(dev) -> None:
    """Host microseconds to enqueue one entry call, one clip at 14x14x288
    -> 576 (the device is then not the limit)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    params, sep = make_entry(288, 576, False, bf, 1, "frac", cpu_gen, dev)
    x = torch.randn((1, FRAMES, 14, 14, 288), generator=gen,
                    device=dev).to(bf)
    fn = lambda: fe.fused_entry_kernel(x, params, sep, max_shift=1)
    us = k2.host_us(fn)
    print(f"  host: {us:.1f} us to enqueue one entry call at "
          f"14x14x288->576, one clip; {cuda_time_ms(fn):.4f} ms a call by "
          f"events")


def _pinned(launch, producers, warps_m, warps_n):
    return {f"{launch}_producers": producers, f"{launch}_warps_m": warps_m,
            f"{launch}_warps_n": warps_n}


# The sweep's settings: the plan's own choice first and last, then pinned
# (producers, warps_m, warps_n) of launch A, of launch B, the gather
# pre-pass forced on and off. A setting that does not fit a width is skipped
# there.
SETTINGS = [{}] + [_pinned(launch, *k) for launch in ("a", "b") for k in (
    (0, 16, 1), (0, 8, 1), (0, 4, 1), (0, 2, 1), (0, 1, 1), (8, 4, 1),
    (12, 2, 1), (4, 2, 1), (12, 1, 1), (4, 1, 1), (0, 8, 2), (0, 4, 2),
    (0, 2, 2), (8, 4, 2), (12, 2, 2), (12, 1, 2), (0, 4, 4), (0, 2, 4),
    (8, 2, 4), (12, 1, 4))] + [{"stage": True}, {"stage": False}, {}]


def sweep(dev, batch, se=False, aq=False) -> bool:
    """Times every setting, each held against the plain version first;
    with ``se`` K3-SE, with ``aq`` K3-AQ beside the block's module path."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    totals = {}
    ok = True
    for h, cin, cm in ENTRY_SHAPES:
        shape = (batch, FRAMES, h, h, cin)
        x = torch.randn(shape, generator=gen, device=dev).to(bf)
        blk = make_block(cin, cm, se, 1, "frac", cpu_gen, dev, aq)
        params = (fe.stack_entry_params_aq(blk, bf, 1) if aq
                  else fe.stack_entry_params(blk, bf, 1))
        sep = stack_se_params([blk])[0] if se else None
        ref = fe.fused_entry_plain(x, params, sep, max_shift=1, aq=aq)
        if aq:
            with torch.no_grad():
                module = lambda: blk(x)
                rel_l2 = k2.rel_errors(module(), ref)[2]
                dev_ms = sum(ms for _, ms in cuda_kernel_times(
                    module, iters=5).values()) / 5
                print(f"  K3-AQ {h}x{h}x{cin}->{cm} batch {batch}, the "
                      f"block's module path: rel_l2 {rel_l2:.1e} against "
                      f"plain, device {dev_ms:.4f} ms, events "
                      f"{cuda_time_ms(module, iters=20):.4f} ms")
        for i, setting in enumerate(SETTINGS):
            try:
                plan = fe.fused_entry_plan(shape, cm, bf,
                                           sms=_sm_count(dev.index),
                                           **setting)
            except ValueError:
                continue  # the setting does not fit this width
            fn = lambda: fe.fused_entry_kernel(x, params, sep, max_shift=1,
                                               aq=aq, overlap=False,
                                               **setting)
            try:
                got = fn()
            except ValueError:
                continue  # the gate's sums do not fit beside this setting
            rel_l2 = k2.rel_errors(got, ref)[2]
            label = (f"K3{'-SE' if se else ''}{'-AQ' if aq else ''} "
                     f"{h}x{h}x{cin}->{cm} batch "
                     f"{batch} "
                     f"{setting or 'defaults'} [{plan.describe()}]")
            if not rel_l2 <= k2.TOL_BF16_REL_L2:
                print(f"  {label}: rel_l2={rel_l2:.3e} against the plain "
                      f"version FAIL")
                ok = False
                continue
            times = cuda_kernel_times(fn, iters=5)
            by = {part: sum(ms for nm, (_, ms) in times.items()
                            if launch_of(nm) == part) / 5
                  for part in ("A", "B", "G", "gate")}
            dev_ms = sum(ms for _, ms in times.values()) / 5
            evt = cuda_time_ms(fn, iters=20)
            t = totals.setdefault(i, [0.0, 0.0, 0.0, 0.0, 0])
            t[0] += by["A"]
            t[1] += by["B"]
            t[2] += dev_ms
            t[3] += evt
            t[4] += 1
            print(f"  {label}: rel_l2 {rel_l2:.1e} ok, device A {by['A']:.4f}"
                  f" gate {by['gate']:.4f} G {by['G']:.4f} B {by['B']:.4f}, "
                  f"all {dev_ms:.4f} ms, events "
                  f"{evt:.4f} ms")
    print("[sweep] summed over the entry shapes the setting fits (of 4): "
          "device ms A, B, all; events ms")
    for i, (a, b, d, e, n) in sorted(totals.items()):
        print(f"  {SETTINGS[i] or 'defaults'}: {a:.3f}, {b:.3f}, {d:.3f}; "
              f"{e:.3f} over {n} shapes")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--se", action="store_true")
    ap.add_argument("--aq", action="store_true")
    args = ap.parse_args(argv)
    if args.se and args.aq:
        ap.error("K3 has no form with both the SE gate and the attention "
                 "mix")
    if not torch.cuda.is_available():
        print("fused_entry_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"[device] {nvidia_smi_line()}; torch {torch.__version__}")
    if args.ptxas:
        k2.ptxas_report(("fused_block_tc.cu", "fused_entry_tc.cu",
                         "fused_entry.cu")
                        + (("se_gate_tc.cu",) if args.se else ()))
    if args.check:
        if not check(dev, args.se, args.aq):
            print("fused_entry_probe: a comparison failed", file=sys.stderr)
            return 1
    if args.host:
        host(dev)
    if args.sweep:
        if not sweep(dev, args.batch, args.se, args.aq):
            print("fused_entry_probe: a swept setting disagrees with the "
                  "plain version", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
