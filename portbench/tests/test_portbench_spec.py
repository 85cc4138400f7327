"""The harness is driven by files: a new configuration, traffic mix, cell
and per-layer metric are found by name, with no edit to a file the
benchmark has; the run's guards (no card, JAX loaded) hold."""

import json
import shutil
import sys
import types

import pytest
import torch

from portbench import run, spec

from .tiny import TINY, TRAFFIC


@pytest.fixture
def new_root(tmp_path):
    """A copy of the benchmark's files with one more configuration, traffic
    mix, cell, limits file and per-layer metric, each added as a file."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = tmp_path / "portbench"
    (base / "configs" / "tiny.json").write_text(json.dumps(TINY))
    (base / "traffic" / "serve.b2.json").write_text(
        json.dumps(TRAFFIC["serve"]))
    (base / "limits" / "tiny.serve.b2.json").write_text(
        json.dumps({"logits_rel_l2": 1e-3}))
    (base / "metrics" / "calls_per_s.serve.py").write_text(
        "def read(ctx):\n    q = ctx.quantities\n"
        "    return q['calls'] / q['window_s']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.serve.b2", "config": "tiny",
                               "traffic": "serve.b2", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "clips_per_s":
            m["workloads"].append("tiny.serve.b2")
    bench["per_layer"].append({
        "name": "calls_per_s.serve", "unit": "calls/s", "better": "higher",
        "source": "host_clock", "layer": "entry", "moves": "clips_per_s",
        "workloads": ["tiny.serve.b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_new_files_are_picked_up(new_root):
    cell = spec.cell(spec.load_benchmark(new_root), "tiny.serve.b2",
                     new_root)
    assert cell["config"] == TINY and cell["traffic"] == TRAFFIC["serve"]
    assert [m["name"] for m in cell["end_to_end"]] == ["clips_per_s",
                                                       "setup_s"]
    assert [m["name"] for m in cell["per_layer"]] == ["calls_per_s.serve"]
    result = run.run_cell(cell, 11, 0.2, False, torch.device("cpu"))
    assert result["correct"]
    assert set(result["metrics"]) == {"clips_per_s", "setup_s"}
    read = spec.reader("calls_per_s.serve", new_root)
    ctx = run.Context(cell["name"], cell["config"], cell["traffic"],
                      {"calls": 10, "window_s": 2.0}, None)
    assert read(ctx) == 5.0


def test_every_cells_files_exist():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert cell["end_to_end"] and cell["per_layer"]
        assert cell["limits"]
        for m in cell["per_layer"]:
            assert callable(spec.reader(m["name"]))


def test_no_card_exits_without_a_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "large.serve.b64", "--seed",
                     str(2**31 + 1), "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_jax_is_found_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "rubiksnet_torch", types.ModuleType(
        "x"))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "rubiksnet_tpu", raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "rubiksnet_tpu.ops", types.ModuleType(
        "x"))
    assert run.forbidden_modules() == ["jax", "rubiksnet_tpu"]
