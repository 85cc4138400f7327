"""The port's measurement entry points on the CPU at a tiny size:
``rubiksnet_torch.scripts.bench`` (serving and training sweeps),
``shift_microbench`` (the 3D shift op alone) and ``data_pipeline_bench``
(the host decode), each through its ``main(argv)`` with ``--device cpu``.

Each prints one JSON line last: it parses, carries its keys, ``correct``
true, ``device`` ``cpu`` and null device metrics; without ``--device cpu``
on a machine without a card each raises; a batch, route or pass made to
fail or to be wrong keeps its error in the line and the exit code is 1.
Sizes: the tiny tier, 4 frames, 32 px, batch 1 and 2, 2 timed calls; the
microbench at its smallest stage (7x7x576, 8 frames) at batch 1."""

import json

import numpy as np
import pytest
import torch

from rubiksnet_torch.data import native_loader
from rubiksnet_torch.scripts import bench, data_pipeline_bench
from rubiksnet_torch.scripts import shift_microbench
from rubiksnet_torch.utils.benchmark import union_length

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--tier", "tiny", "--frames", "4", "--size",
        "32", "--batch-sizes", "1", "2", "--iters", "2", "--warmup", "1"]
SHARES = ("mfu", "hbm_share", "busy_share", "achieved_tflops")


def last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("mode,extra", [
    ("infer", []), ("infer", ["--backend", "module"]),
    ("infer", ["--variant", "rubiks3d-aq"]),
    ("train", ["--dtype", "float32"]), ("train", [])])
def test_bench_line(capsys, mode, extra):
    assert bench.main(TINY + ["--mode", mode] + extra) == 0
    line = last_line(capsys)
    assert set(line) == {"metric", "value", "unit", "vs_baseline",
                         "correct", "detail"}
    assert line["correct"] is True and line["unit"] == "clips/s"
    detail = line["detail"]
    assert detail["device"] == "cpu" and detail["card"] is None
    assert set(detail["points"]) == {"1", "2"} == set(detail["batch_sweep"])
    assert detail["best_batch"] in (1, 2)
    assert line["value"] == max(detail["batch_sweep"].values()) > 0
    for point in detail["points"].values():
        assert point["correct"] is True
        assert point["ms"]["n"] == 2
        assert point["ms"]["p10"] <= point["ms"]["median"] <= (
            point["ms"]["p90"])
        assert point["flops"] > 0 and point["bytes"] > 0
        assert set(point["launches"]) >= {"shift3d", "fused_block"}
        assert point["peak_memory_gib"] is None
        assert all(point[k] is None for k in SHARES + (
            "busy_ms", "profiled_ms", "device_records_per_call"))
    assert all(v is None for u in detail["utilization"].values()
               for v in u.values())
    if mode == "infer":
        assert line["vs_baseline"] == line["value"] / 125.0
        assert line["metric"].endswith("-backend inference")
    else:
        assert line["vs_baseline"] is None
        assert set(detail["train_step_over_forward"]) == {"1", "2"}
        assert all(p["loss"] == pytest.approx(p["plain_loss"], rel=1e-2)
                   for p in detail["points"].values())


def test_bench_flops_are_the_roofline_counts(capsys):
    from rubiksnet_torch.models import create_rubiksnet
    from rubiksnet_torch.utils.roofline import model_flops

    assert bench.main(TINY + ["--batch-sizes", "2"]) == 0
    point = last_line(capsys)["detail"]["points"]["2"]
    model = create_rubiksnet("tiny", 174, 4, device="cpu")
    assert point["flops"] == model_flops(model, 2, 4, 32)


def test_bench_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(TINY[2:])


def test_bench_keeps_a_failed_batch(capsys, monkeypatch):
    real = bench.infer_point

    def infer_point(args, model, forward, batch, dev):
        if batch == 2:
            raise RuntimeError("out of memory at batch 2")
        return real(args, model, forward, batch, dev)

    monkeypatch.setattr(bench, "infer_point", infer_point)
    assert bench.main(TINY) == 1
    line = last_line(capsys)
    assert line["correct"] is False
    points = line["detail"]["points"]
    assert points["1"]["correct"] is True
    assert points["2"] == {"correct": False,
                           "failure": "RuntimeError: out of memory at "
                                      "batch 2"}
    assert set(line["detail"]["batch_sweep"]) == {"1"}


def test_bench_keeps_a_wrong_batch(capsys, monkeypatch):
    class Wrong(bench.FusedExecutor):
        def __call__(self, video, clips=None):
            return super().__call__(video) + 1.0

    monkeypatch.setattr(bench, "FusedExecutor", Wrong)
    assert bench.main(TINY) == 1
    line = last_line(capsys)
    assert line["correct"] is False and line["value"] == 0.0
    for point in line["detail"]["points"].values():
        assert point["correct"] is False
        assert point["rel_l2"] > point["tolerance"]
        assert "ms" in point  # still timed, left out of the sweep
    assert line["detail"]["batch_sweep"] == {}


MICRO = ["--device", "cpu", "--batch", "1", "--stages", "stage4",
         "--rounds", "2", "--iters", "2"]


def test_microbench_line(capsys, tmp_path):
    out = tmp_path / "micro.json"
    assert shift_microbench.main(MICRO + ["--out", str(out)]) == 0
    line = last_line(capsys)
    assert json.loads(out.read_text()) == line
    assert line["correct"] is True and line["device"] == "cpu"
    assert line["card"] is None
    case = line["cases"]["stage4"]
    assert case["shape"] == [1, 8, 7, 7, 576]
    want = {"fwd": {"kernel", "plain", "library"},
            "bwd": {"kernel", "plain"},
            "input_grad": {"kernel", "plain", "library"},
            "shift_grad": {"kernel", "plain"}}
    for mode, routes in want.items():
        cell = case[mode]
        assert set(cell["routes"]) == routes
        assert cell["winner"] in routes
        assert cell["bound_ms"] > 0 and cell["bound_by"] in ("bytes",
                                                             "operations")
        for row in cell["routes"].values():
            assert row["correct"] is True and len(row["ms"]) == 2
            assert row["median_ratio_vs_best"] >= 1.0


def test_microbench_float32_and_unknown_names(capsys):
    assert shift_microbench.main(MICRO + ["--dtype", "float32", "--modes",
                                          "fwd,shift_grad"]) == 0
    line = last_line(capsys)
    assert line["correct"] is True and set(line["cases"]["stage4"]) == {
        "shape", "fwd", "shift_grad"}
    with pytest.raises(ValueError, match="unknown modes"):
        shift_microbench.main(MICRO + ["--modes", "fwd,auto"])


def test_microbench_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shift_microbench.main(MICRO[2:])


def test_microbench_keeps_a_wrong_route(capsys, monkeypatch):
    def zeros(x, shift, s, inverse=False):
        return lambda: torch.zeros_like(x).permute(0, 4, 1, 2, 3)

    monkeypatch.setattr(shift_microbench, "library_shift", zeros)
    assert shift_microbench.main(MICRO + ["--modes", "fwd"]) == 1
    line = last_line(capsys)
    assert line["correct"] is False
    library = line["cases"]["stage4"]["fwd"]["routes"]["library"]
    assert library["correct"] is False
    assert library["errors"][0]["value"] > library["errors"][0]["tolerance"]


DATA = ["--device", "cpu", "--videos", "2", "--frames", "4", "--repeats",
        "1"]


def test_data_pipeline_line(capsys):
    built = native_loader.available()
    assert data_pipeline_bench.main(DATA) == 0
    line = last_line(capsys)
    assert line["correct"] is True and line["device"] == "cpu"
    assert line["native_built"] is built
    assert set(line["protocols"]) == {"1clip", "2clip"}
    for name, views in (("1clip", 1), ("2clip", 6)):
        entry = line["protocols"][name]
        assert entry["views_per_video"] == views
        pil = entry["pil"]
        assert pil["correct"] is True
        assert pil["clips_per_s"] == pytest.approx(views
                                                   * pil["videos_per_s"])
        assert pil["ms_per_frame"] > 0
        if built:
            assert entry["native"]["correct"] is True
            assert entry["max_pixel_diff"] <= 1
        else:
            assert entry["native"]["built"] is False


def test_data_pipeline_device_row(capsys):
    """On the CPU the device loader's row runs its plain versions (Pillow's
    decode, the C++ loader's resize), in batches of the evaluator's size,
    and is held to PIL's clips within DECODE_BOUND."""
    assert data_pipeline_bench.main(DATA) == 0
    line = last_line(capsys)
    assert line["device_built"] is None  # nothing to build on the CPU
    assert line["out_dtype"]["device"] == "uint8 on cpu"
    assert line["frames_per_video"] == 8 and line["frame_px"] == (
        "427x240 jpeg q95")
    for name, views, frames in (("1clip", 1, 4), ("2clip", 6, 8)):
        row = line["protocols"][name]["device"]
        assert row["correct"] is True and row["within_bound"] is True
        assert row["clips_per_s"] == pytest.approx(views
                                                   * row["videos_per_s"])
        assert row["backend_frames"] == {"pillow": 2 * frames}
        assert row["launches"] == 0  # no kernel on the CPU
        assert max(row["max_abs_diff"]) <= 1  # Pillow's resize rounding
        assert row["batch_videos"] == (32 if name == "1clip" else 8)


def test_data_pipeline_keeps_a_wrong_device_clip(capsys, monkeypatch):
    from rubiksnet_torch.data import device_loader

    real = device_loader.plain_decode

    def bright(blob):
        return (real(blob).astype(np.int16) + 9).clip(0, 255).astype(
            np.uint8)

    monkeypatch.setattr(device_loader, "plain_decode", bright)
    assert data_pipeline_bench.main(DATA) == 1
    line = last_line(capsys)
    assert line["correct"] is False
    for entry in line["protocols"].values():
        assert entry["device"]["correct"] is False
        assert entry["device"]["within_bound"] is False
        assert entry["pil"]["correct"] is True


def _load_script(name):
    """A JAX-side script of scripts/, loaded by its path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_side_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(root):
    from pathlib import Path

    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_data_pipeline_frames_equal_the_jax_bench(tmp_path):
    """make_frames writes scripts/data_pipeline_bench.py's files byte for
    byte (frames, folders, the list file)."""
    jax_side = _load_script("data_pipeline_bench")
    jax_side.make_frames(str(tmp_path / "jax"), 3, 8)
    data_pipeline_bench.make_frames(str(tmp_path / "port"), 3, 8)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(want) == 3 * 8 + 1 and "val.txt" in want
    assert got == want


def test_eval_throughput_frames_equal_the_jax_script(tmp_path):
    """eval_throughput at --frames-per-video 16 writes
    scripts/eval_throughput.py's files byte for byte; without a count it
    keeps its drawn 24-48 frames a video."""
    from rubiksnet_torch.scripts import eval_throughput

    jax_side = _load_script("eval_throughput")
    jax_side.generate_frames(str(tmp_path / "jax"), 3, 16, 5, seed=0)
    eval_throughput.generate_frames(str(tmp_path / "port"), 3, 5, seed=0,
                                    frames_per_video=16)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(want) == 3 * 16 + 1
    assert got == want
    drawn = eval_throughput.generate_frames(str(tmp_path / "drawn"), 3, 5)
    counts = [int(ln.split()[1]) for ln in open(drawn).read().split("\n")
              if ln]
    assert all(24 <= c <= 48 for c in counts) and counts != [16] * 3


def test_data_pipeline_names_a_native_build_error(capsys, monkeypatch):
    def no_libjpeg():
        raise RuntimeError("building the native frame loader failed: no "
                           "jpeglib.h")

    monkeypatch.setattr(native_loader, "load_library", no_libjpeg)
    assert data_pipeline_bench.main(DATA) == 0
    line = last_line(capsys)
    assert line["native_built"] is False and line["correct"] is True
    for entry in line["protocols"].values():
        assert entry["native"] == {
            "built": False, "correct": True,
            "error": "building the native frame loader failed: no "
                     "jpeglib.h"}
        assert entry["pil"]["correct"] is True  # not replaced by PIL


def test_data_pipeline_keeps_a_failed_pass(capsys, monkeypatch):
    def broken(ds, repeats):
        raise OSError("truncated JPEG")

    monkeypatch.setattr(data_pipeline_bench, "time_passes", broken)
    assert data_pipeline_bench.main(DATA) == 1
    line = last_line(capsys)
    assert line["correct"] is False
    assert line["protocols"]["1clip"]["pil"] == {
        "correct": False, "failure": "OSError: truncated JPEG"}


def test_data_pipeline_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data_pipeline_bench.main(DATA[2:])


def test_union_length_counts_overlap_once():
    assert union_length([(0.0, 2.0)]) == 2.0
    assert union_length([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]) == 4.0
    assert union_length([(0.0, 4.0), (1.0, 2.0), (4.0, 5.0)]) == 5.0
    spans = sorted(np.random.default_rng(0).uniform(0, 10, (50, 2)).tolist())
    spans = [(a, a + abs(b) / 10) for a, b in spans]
    grid = np.linspace(0, 12, 120001)
    covered = np.zeros_like(grid, dtype=bool)
    for a, b in spans:
        covered |= (grid >= a) & (grid < b)
    assert union_length(spans) == pytest.approx(covered.mean() * 12,
                                                abs=1e-3)
