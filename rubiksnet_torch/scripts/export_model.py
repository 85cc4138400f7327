"""Export a RubiksNet as a self-contained serving program.

Counterpart of ``scripts/export_model.py``: ``torch.export`` traces the
multi-view eval forward and writes one file that a serving process runs
with ``rubiksnet_torch.serving.load_exported`` and ``run_exported``, with
no model code (``rubiksnet_torch/serving/export.py``). The kernels are in
the program as ``rubiksnet::`` operators. The program runs on the device
it was exported on: the CUDA card by default, the CPU with ``--device
cpu``.

With --check the file is reloaded and its logits are held, on a seeded
video, against the live route it was traced from (the FusedExecutor with
--fused, else the module path: the same kernels and plans on the same
input) and against a second reference. In float32: the live route within
rtol 2e-4 and atol 2e-5 (the JAX script's bounds), and with --fused the
module path within relative L2 1e-4 (the float32 bound of the whole model
in chip_smoke.py: K2's and K3's sums run in another order than the module
path's GEMMs). In bfloat16: equal to the live route, or within relative
L2 1e-3 of it, and within relative L2 5e-2 of the plain model
(``plain=True``, the bfloat16 bound of the whole model in chip_smoke.py).

Examples:
  python -m rubiksnet_torch.scripts.export_model --checkpoint \\
      ckpts/rubiks3d_large.pth.tar --batch-size 64 --crops 6 --fused \\
      --dtype bfloat16 --out large_2clip.pt2
  python -m rubiksnet_torch.scripts.export_model --tier tiny \\
      --batch-size 4 --input-size 64 --out tiny.pt2 --check --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models import FusedExecutor, create_rubiksnet, load_pretrained
from ..models.rubiksnet import resolve_device
from ..serving import (
    MAX_BATCH,
    export_eval_fn,
    load_exported,
    operator_counts,
    run_exported,
    save_exported,
)

RTOL_F32, ATOL_F32 = 2e-4, 2e-5
TOL_F32_MODULE = 1e-4  # relative L2, a fused program against the module path
TOL_BF16_PLAIN = 5e-2  # relative L2 against the plain model
TOL_BF16_LIVE = 1e-3   # relative L2 against the live route, where not equal


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="export a RubiksNet as a torch.export serving program")
    p.add_argument("--checkpoint", default=None,
                   help=".pth.tar checkpoint (default: random weights of "
                        "--tier, seed 0)")
    p.add_argument("--tier", default="large")
    p.add_argument("--variant", default="rubiks3d")
    p.add_argument("--num-classes", type=int, default=174)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--input-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--crops", type=int, default=1,
                   help="views per clip averaged inside the program "
                        "(2-clip x 3-crop protocol = 6)")
    p.add_argument("--fused", action="store_true",
                   help="the FusedExecutor's route (K2 and K3 operators)")
    p.add_argument("--polymorphic-batch", action="store_true")
    p.add_argument("--max-batch", type=int, default=MAX_BATCH,
                   help="the symbolic batch's maximum")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the model's compute dtype (the input stays "
                        "float32)")
    p.add_argument("--out", required=True)
    p.add_argument("--check", action="store_true",
                   help="reload the program and hold its logits against "
                        "the live model")
    return p


def rel_l2(got, want) -> float:
    d = (got.float() - want.float()).norm()
    return float(d) / max(float(want.float().norm()), 1e-30)


def check(args, model, path) -> None:
    """Reload ``path`` and hold its logits against the live model (see the
    module docstring); raises AssertionError where they disagree."""
    device = next(model.parameters()).device
    video = torch.from_numpy(np.random.RandomState(0).randn(
        args.batch_size, args.crops, args.frames, args.input_size,
        args.input_size, 3).astype(np.float32)).to(device)
    got = run_exported(load_exported(path), video)
    flat = video.reshape((-1,) + tuple(video.shape[2:]))

    def views(logits):
        return logits.reshape(args.batch_size, args.crops, -1).mean(dim=1)

    route = "executor" if args.fused else "module path"
    with torch.no_grad():
        module = views(model(flat))
        live = views(FusedExecutor(model)(flat)) if args.fused else module
        if model.dtype == torch.float32:
            torch.testing.assert_close(got, live, rtol=RTOL_F32,
                                       atol=ATOL_F32)
            print(f"check: program vs the live {route} within rtol "
                  f"{RTOL_F32}, atol {ATOL_F32}")
            if args.fused:
                to_module = rel_l2(got, module)
                print(f"check: program vs the module path rel_l2 "
                      f"{to_module:.3e} [<= {TOL_F32_MODULE}]")
                if to_module > TOL_F32_MODULE:
                    raise AssertionError("program logits outside their "
                                         "bounds")
            print("check OK")
            return
        plain = views(model(flat, plain=True))
    to_plain, to_live = rel_l2(got, plain), rel_l2(got, live)
    equal = torch.equal(got, live)
    print(f"check: program vs plain model rel_l2 {to_plain:.3e} [<= "
          f"{TOL_BF16_PLAIN}]; vs the live {route}: "
          f"{'bit-identical' if equal else f'rel_l2 {to_live:.3e}'}")
    if to_plain > TOL_BF16_PLAIN or not (equal or to_live <= TOL_BF16_LIVE):
        raise AssertionError("program logits outside their bounds")
    print("check OK")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.checkpoint:
        model = load_pretrained(args.checkpoint, device=device, dtype=dtype)
        args.frames = model.num_frames
    else:
        model = create_rubiksnet(args.tier, args.num_classes, args.frames,
                                 variant=args.variant, device=device,
                                 dtype=dtype)
    exported = export_eval_fn(
        model, args.batch_size, num_crops=args.crops,
        input_size=args.input_size, fused=args.fused,
        polymorphic_batch=args.polymorphic_batch, max_batch=args.max_batch)
    save_exported(args.out, exported)
    ops = {k: v for k, v in sorted(operator_counts(exported).items())
           if k.startswith("rubiksnet.")}
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB, "
          f"device {device}, operators {ops})")
    if args.check:
        check(args, model, args.out)


if __name__ == "__main__":
    main()
