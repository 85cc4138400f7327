"""The correctness check's controls, read on the card at a cell's own size:

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 [--batch N]

For each seed it makes the cell's weights and inputs as a run does and
compares, by the cell's own numbers, the float32 reference with

* ``fp8``: the reference with every matrix product's operands rounded to
  float8 e4m3 (the precision below the configuration's bfloat16), put in
  the program's place;
* for a training cell also ``half_batch``: the reference whose loss is the
  mean over the first half of each batch only.

Each seed prints one JSON line of readings; the limits in
``limits/<cell>.json`` lie between the program's readings and these.
The benchmark's runs never run this. ``--batch`` makes the same check at
a smaller batch (the test in ``tests/test_portbench_control.py``).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import spec
from .compare import worst_clip_rel_l2
from .kinds import evaluate, serve, train
from .reference import Reference, make_weights


def serve_readings(cfg, traffic, seed, device):
    weights, pool = serve.make_inputs(cfg, traffic, seed, device)
    ref = Reference(cfg, weights)
    low = Reference(cfg, weights, "fp8")
    worst = 0.0
    for p in range(min(traffic["check_calls"], len(pool))):
        rows = traffic["reference_rows"]
        worst = max(worst, worst_clip_rel_l2(low.logits(pool[p], rows),
                                             ref.logits(pool[p], rows)))
    return {"fp8": {"logits_rel_l2": worst}}


def train_readings(cfg, traffic, seed, device):
    weights, pool = train.make_inputs(cfg, traffic, seed, device)
    want = train.reference_steps(cfg, traffic, weights, pool)
    out = {}
    for name, kw in (("fp8", {"precision": "fp8"}),
                     ("half_batch", {"rows": traffic["batch"] // 2})):
        got = train.reference_steps(cfg, traffic, weights, pool, **kw)
        out[name] = train.compared(cfg, traffic, weights, got, want)
    return out


def eval_readings(cfg, traffic, seed, device):
    import tempfile

    import torch

    with tempfile.TemporaryDirectory(prefix="portbench_control_") as root:
        _, videos = evaluate.make_videos(cfg, traffic, seed, root)
        gen = torch.Generator(device=device).manual_seed(seed)
        weights = make_weights(cfg, gen, device)
        ref = Reference(cfg, weights)
        low = Reference(cfg, weights, "fp8")
        rows, worst = traffic["reference_rows"], 0.0
        for i in range(0, len(videos), rows):
            clips = evaluate.reference_clips(
                cfg, traffic, root, videos, range(i, min(i + rows,
                                                         len(videos))),
                device)
            worst = max(worst, worst_clip_rel_l2(low.logits(clips, rows),
                                                 ref.logits(clips, rows)))
    return {"fp8": {"logits_rel_l2": worst}}


READINGS = {"serve": serve_readings, "train": train_readings,
            "evaluate": eval_readings}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--batch", type=int, default=None)
    args = p.parse_args(argv)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    cfg, traffic = cell["config"], dict(cell["traffic"])
    if args.batch:
        traffic["batch"] = args.batch
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    read = READINGS[traffic["kind"]]
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "batch": traffic["batch"],
                          "readings": read(cfg, traffic, seed, dev),
                          "limits": cell["limits"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
