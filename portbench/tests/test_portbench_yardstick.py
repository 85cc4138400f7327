"""The frozen work counts equal the port's ``utils/roofline.py`` for the
benchmark's configurations today, and the shapes they count are the
model's."""

import json

import pytest
import torch

from portbench import spec
from portbench import yardstick as ys
from rubiksnet_torch.models.rubiksnet import RubiksNet
from rubiksnet_torch.utils import roofline

CONFIGS = ["large", "large_aq"]


def load(name):
    with open(spec.ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def port_model(cfg):
    return RubiksNet(cfg["tier"], cfg["num_classes"], cfg["num_frames"],
                     cfg["variant"], cfg["quantize"], cfg["max_shift"],
                     torch.bfloat16)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("mode", ["infer", "train"])
def test_model_counts_equal_the_port(name, batch, mode):
    cfg = load(name)
    model = port_model(cfg)
    args = (batch, cfg["num_frames"], cfg["input_size"], mode)
    assert ys.model_flops(cfg, batch, mode) == roofline.model_flops(
        model, *args)
    assert ys.model_bytes(cfg, batch, mode) == roofline.model_bytes(
        model, *args)


@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("aq", [False, True])
def test_kernel_counts_equal_the_port(batch, aq):
    for h, c in [(112, 72), (56, 72), (28, 144), (14, 288), (7, 576)]:
        assert ys.block_work(batch, h, c, 2, 13, aq) == roofline.block_work(
            batch, h, c, 2, 13, aq)
        n = batch * 8 * h * h * c
        assert ys.shift_work(n // 4, n, 2, 8) == roofline.shift_work(
            n // 4, n, 2, 8)
        assert ys.shift_grad_work(n, n, 2) == roofline.shift_grad_work(
            n, n, 2)
    assert ys.PEAK_BF16 == roofline.PEAK_BF16
    assert ys.HBM_BYTES_PER_S == roofline.HBM_BYTES_PER_S


@pytest.mark.parametrize("name", CONFIGS)
def test_shapes_are_the_models(name):
    cfg = load(name)
    model = port_model(cfg)
    blocks = list(model.backbone.named_blocks())
    assert len(ys.blocks(cfg)) == len(blocks) == 51
    for (_, blk), (_, _, cin, cout, st, _) in zip(blocks, ys.blocks(cfg)):
        assert (blk.in_planes, blk.out_planes, blk.stride) == (cin, cout, st)
    assert len(ys.stride1_blocks(cfg)) == 47
    assert ys.block_rows(cfg) == (16 if cfg["variant"] == "rubiks3d-aq"
                                  else 13)


def test_union_and_classes():
    assert ys.union_length([(3, 4), (0, 2), (1, 2.5)]) == 3.5
    assert ys.union_length([]) == 0.0
    assert ys.classify("void rubiks::rubiks_tc_kernel<2>(rubiks::TcArgs)"
                       ).startswith("K2")
    assert ys.classify("rubiks::rubiks_entry_tc_kernel<4>").startswith("K3")
    assert ys.classify("at::native::reduce_kernel<...>") == "reductions"
