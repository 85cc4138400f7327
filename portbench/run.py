"""Run one cell of the port's benchmark once and print one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program (``rubiksnet_torch``). Set-up (``setup_s``: process start
to the first timed call) makes the weights and inputs on the card from
the seed, builds the cell's entry point and warms up every shape the cell
uses. The window then makes back-to-back calls for ``--seconds``; its
end-to-end metrics are all its work over all its time. With ``--trace 1``
a traced window of the traffic's ``trace_calls`` calls follows, and the
line holds the per-layer metrics instead, with the device's busy and
window seconds and a breakdown. After the window the program's state is
freed and the plain reference (``reference.py``) judges what the timed
path produced; each number compared is printed beside its limit, last on
standard error and last in the line (``checks``).

Exit codes: 0 with a result; 2 without the CUDA devices the cell needs;
3 where JAX or the JAX package was loaded; 1 on any other failure. None
but 0 prints a result.
"""

from __future__ import annotations

import time

T0 = time.time()  # set-up is timed from here, the process's first step

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from . import spec  # noqa: E402
from .compare import passed  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rubiksnet_tpu")
CACHE_DIR = ".portbench_cache"


@dataclass
class Context:
    """What a per-layer metric's reader gets: the cell's configuration and
    traffic, the window's quantities (calls, seconds, the kind's own
    counters) and the traced window."""

    cell: str
    config: dict
    traffic: dict
    quantities: dict
    trace: object


def cache_env(root):
    """Every kernel and build cache at a fixed path inside the checkout."""
    base = os.path.join(str(root), CACHE_DIR)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(base, "inductor")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell, seed, seconds, trace, device, t0=T0):
    """Set up, time, trace and check one cell: -> the result's dict (the
    ``checks`` key last)."""
    import torch

    kind = importlib.import_module(f"portbench.kinds.{cell['traffic']['kind']}")
    session = kind.Session(cell["config"], cell["traffic"], seed, device)
    session.setup()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.time() - t0
    start = time.perf_counter()
    deadline, calls = start + seconds, 0
    while time.perf_counter() < deadline or calls == 0:
        session.call()
        calls += 1
    window_s = time.perf_counter() - start
    quantities = session.quantities(window_s, calls)
    traced = None
    if trace:
        from .trace import traced as run_traced

        traced = run_traced(session.call, cell["traffic"]["trace_calls"])
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    if trace:
        ctx = Context(cell["name"], cell["config"], cell["traffic"],
                      quantities, traced)
        for m in cell["per_layer"]:
            value = spec.reader(m["name"], cell["root"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            value = setup_s if m["name"] == "setup_s" else quantities[
                m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    session.release()
    checks = session.check(cell["limits"])
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
    result = {"correct": all(passed(c) for c in checks), "attempted": calls,
              "failed": 0, "metrics": metrics, "device": dev}
    if traced is not None:
        result["breakdown"] = traced.breakdown()
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    cache_env(spec.ROOT)
    import torch

    chips = cell["entry"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        verdict = ("read, not compared" if c["limit"] is None else
                   "ok" if passed({"value": c["value"], "limit": c["limit"]})
                   else "FAILED")
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
