"""What a cell is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cells, their configurations, traffic mixes and
metrics; each of those is a file of its own under ``portbench/``:

* ``configs/<config>.json``: the model's sizes (the path is the
  configuration's ``file`` in ``BENCHMARK.json``);
* ``traffic/<traffic>.json``: the traffic mix, whose ``kind`` names the
  generator in ``kinds/`` that reads it;
* ``limits/<cell>.json``: the limit of each number the correctness check
  compares in that cell;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a function
  ``read(ctx)`` that returns the value or None where it finds nothing.

A new cell, configuration, traffic mix or metric is a new file and a new
entry in ``BENCHMARK.json``; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load_benchmark(root=ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path):
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str, root=ROOT) -> dict:
    """The cell ``name``: its entry, configuration, traffic mix and limits,
    and the end-to-end and per-layer metrics it reports."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    base = Path(root)
    config = _json(base / configs[entry["config"]]["file"])
    traffic = _json(base / "portbench" / "traffic" / f"{entry['traffic']}.json")
    limits = _json(base / "portbench" / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {"name": name, "root": base, "entry": entry, "config": config,
            "traffic": traffic, "limits": limits, "end_to_end": e2e,
            "per_layer": per_layer}


def reader(metric_name: str, root=ROOT):
    """The ``read(ctx)`` of ``portbench/metrics/<metric_name>.py``."""
    path = Path(root) / "portbench" / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric_name.replace(".", "_").replace(
            "-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
