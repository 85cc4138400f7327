"""The SE tier's cell: ``small.serve.b64`` is found by its files, reports
the serving metrics and ``se_gate_share.serve``, whose reader counts the
gate's overlapping launches once and reads None where the trace holds no
gate; on the card the fp8 control fails its check."""

import pytest
import torch

from portbench import control_se, spec
from portbench.compare import passed
from portbench.trace import Trace

CELL = "small.serve.b64"


def test_the_cell_is_found_by_its_files():
    cell = spec.cell(spec.load_benchmark(), CELL)
    cfg = cell["config"]
    assert (cfg["tier"], cfg["use_se"], cfg["width"], cfg["repeats"],
            cfg["max_shift"], cfg["dtype"]) == ("small", True, 72,
                                                [3, 4, 6, 3], 1, "bfloat16")
    assert cell["traffic"]["kind"] == "serve_se"
    assert cell["traffic"]["batch"] == 64
    assert [m["name"] for m in cell["end_to_end"]] == ["clips_per_s",
                                                       "setup_s"]
    assert {m["name"] for m in cell["per_layer"]} == {
        "idle_share.serve", "mfu.serve", "device_ops_per_clip.serve",
        "k2_roofline.serve", "program_setup_s.serve", "se_gate_share.serve",
        "entry_share.serve"}


def test_gate_share_counts_overlapping_launches_once():
    read = spec.reader("se_gate_share.serve")
    gate = "rubiks::(anonymous namespace)::se_gate_tc_kernel(GateArgs)"
    device = [(gate, 0.0, 1.0), (gate, 0.5, 1.5),
              ("void rubiks::rubiks_tc_kernel<5>(rubiks::TcArgs)", 1.5, 4.0)]
    ctx = type("Ctx", (), {"trace": Trace(device, 5.0, 2)})
    assert read(ctx) == pytest.approx(100.0 * 1.5 / 4.0)
    ctx.trace = Trace(device[2:], 5.0, 2)
    assert read(ctx) is None


@pytest.mark.card
def test_control_fails_the_check():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.cell(spec.load_benchmark(), CELL)
    traffic = dict(cell["traffic"], batch=8)
    readings = control_se.serve_readings(cell["config"], traffic, 2**31 + 17,
                                         torch.device("cuda", 0))
    value = readings["fp8"]["logits_rel_l2"]
    assert not passed({"value": value,
                       "limit": cell["limits"]["logits_rel_l2"]}), value
