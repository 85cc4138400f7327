"""A tiny configuration and tiny traffic mixes for the CPU tests: the
program's plain versions run there in float32 (or bfloat16) at 32 px."""

import copy

TINY = {"tier": "tiny", "variant": "rubiks3d", "width": 54,
        "repeats": [3, 4, 6, 3], "use_se": False, "num_classes": 10,
        "num_frames": 4, "input_size": 32, "quantize": False,
        "max_shift": 1, "dtype": "float32"}

TRAFFIC = {
    "serve": {"kind": "serve", "batch": 2, "pool": 2, "warmup_calls": 1,
              "trace_calls": 2, "check_calls": 2, "reference_rows": 2},
    "train": {"kind": "train", "batch": 4, "pool": 4, "first_steps": 3,
              "lr": 0.001, "shift_mult": 0.1, "momentum": 0.9,
              "weight_decay": 1e-4, "trace_calls": 2},
    "evaluate": {"kind": "evaluate", "batch": 3, "videos": 4,
                 "frame_size": [60, 40], "frames_per_video": [6, 10],
                 "quality": 87, "repeats": 50, "scale_size": 36,
                 "crop_size": 32, "prefetch": 2, "warmup_calls": 1,
                 "trace_calls": 2, "check_calls": 2, "reference_rows": 4},
}


def config(**overrides):
    cfg = copy.deepcopy(TINY)
    cfg.update(overrides)
    return cfg


def cell(kind, limits, **overrides):
    """A cell dict as ``spec.cell`` returns it, on the tiny configuration,
    reporting ``setup_s`` alone."""
    return {"name": f"tiny.{kind}", "root": None, "config": config(
        **overrides), "traffic": copy.deepcopy(TRAFFIC[kind]),
        "limits": limits, "end_to_end": [{"name": "setup_s", "unit": "s"}],
        "per_layer": []}
