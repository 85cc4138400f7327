"""The yardstick (``rubiksnet_torch.utils.roofline``) on the CPU.

* The per-kernel work counts that ``chip_smoke.py`` bounds every kernel
  with keep their values: the numbers below are what its own definitions
  gave before they moved, at Large's stage shapes at batch 8 in bfloat16
  (rows of parameters as its timing phase passes them: 13 for K2, 16 for
  K2-AQ, 11 for K3).
* :func:`model_flops` equals ``torch.utils.flop_counter.FlopCounterMode``'s
  total over the plain module path, exactly, for one forward and for one
  train step.
* :func:`model_bytes` equals the same count taken from the tensors a
  forward really passes between its layers (forward hooks).
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from rubiksnet_torch.models import create_rubiksnet
from rubiksnet_torch.train import make_train_step, sgd_with_shift_mult
from rubiksnet_torch.utils import roofline

torch.set_num_threads(1)

BATCH = 8
BLOCK_SHAPES = [(112, 72), (56, 72), (28, 144), (14, 288), (7, 576)]
ENTRY_SHAPES = [(112, 72, 72), (56, 72, 144), (28, 144, 288),
                (14, 288, 576)]
SHIFT = {112: (231211008, 0, 1849688064), 56: (57802752, 0, 462422016),
         28: (28901376, 0, 231211008), 14: (14450688, 0, 115605504),
         7: (7225344, 0, 57802752)}
GRAD = {112: (231211008, 0, 2312110080), 56: (57802752, 0, 578027520),
        28: (28901376, 0, 289013760), 14: (14450688, 0, 144506880),
        7: (7225344, 0, 72253440)}
BLOCK = {  # (h, aq, se)
    (112, False, False): (231235488, 16647192576, 2196504576),
    (112, True, False): (231236352, 16647192576, 1618477056),
    (112, False, True): (231238944, 16647192576, 2369912832),
    (56, False, False): (57827232, 4161798144, 549126144),
    (56, True, False): (57828096, 4161798144, 404619264),
    (56, False, True): (57830688, 4161798144, 592478208),
    (28, False, False): (28991808, 4161798144, 274563072),
    (28, True, False): (28993536, 4161798144, 202309632),
    (28, False, True): (29005632, 4161798144, 296239104),
    (14, False, False): (14797440, 4161798144, 137281536),
    (14, True, False): (14800896, 4161798144, 101154816),
    (14, False, True): (14852736, 4161798144, 148119552),
    (7, False, False): (8582400, 4161798144, 68640768),
    (7, True, False): (8589312, 4161798144, 50577408),
    (7, False, True): (8803584, 4161798144, 74059776),
}
ENTRY = {  # (h, se)
    (112, False): (144541728, 12485394432, 693633024),
    (112, True): (144545184, 12485394432, 867041280),
    (56, False): (43441920, 7283146752, 317915136),
    (56, True): (43455744, 7283146752, 404619264),
    (28, False): (22021632, 7283146752, 158957568),
    (28, True): (22076928, 7283146752, 202309632),
    (14, False): (12192768, 7283146752, 79478784),
    (14, True): (12413952, 7283146752, 101154816),
}


@pytest.mark.parametrize("h,c", BLOCK_SHAPES)
def test_shift_work_keeps_its_values(h, c):
    n = BATCH * roofline.FRAMES * h * h * c
    assert roofline.shift_work(n, n, 2, 8) == SHIFT[h]
    assert roofline.shift_grad_work(n, n, 2) == GRAD[h]


@pytest.mark.parametrize("aq,se", [(False, False), (True, False),
                                   (False, True)])
@pytest.mark.parametrize("h,c", BLOCK_SHAPES)
def test_block_work_keeps_its_values(h, c, aq, se):
    rows = 16 if aq else 13
    assert roofline.block_work(BATCH, h, c, 2, rows, aq, se) == BLOCK[
        h, aq, se]


@pytest.mark.parametrize("se", [False, True])
@pytest.mark.parametrize("h,cin,cm", ENTRY_SHAPES)
def test_entry_work_keeps_its_values(h, cin, cm, se):
    assert roofline.entry_work(BATCH, h, cin, cm, 2, 11, se) == ENTRY[h, se]


@pytest.mark.parametrize("h,cin,cm", ENTRY_SHAPES)
def test_entry_work_with_the_attention_mix(h, cin, cm):
    """K3-AQ's count is K3's with two more reads of x (the mix's frames t - 1
    and t + 1) and three rows of weights, six more operations an input
    element, and four shift corners an output element, not eight."""
    m = BATCH * roofline.FRAMES * h * h
    mo = m // 4
    nbytes, mm, other = roofline.entry_work(BATCH, h, cin, cm, 2, 11)
    assert roofline.entry_work(BATCH, h, cin, cm, 2, 11, aq=True) == (
        nbytes + 2 * m * cin * 2 + 3 * cin * 4, mm,
        other + 6 * m * cin - mo * cm * 4 * roofline.FLOPS_PER_CORNER)


def test_bound_times_use_the_peaks():
    work = BLOCK[14, False, False]
    tb, to = roofline.bound_times_ms(work, torch.bfloat16)
    assert tb == pytest.approx(1e3 * work[0] / 3.35e12, rel=1e-12)
    assert to == pytest.approx(1e3 * (work[1] / 989e12 + work[2] / 67e12),
                               rel=1e-12)
    _, to32 = roofline.bound_times_ms(work, torch.float32)
    assert to32 == pytest.approx(1e3 * (work[1] + work[2]) / 67e12,
                                 rel=1e-12)
    assert roofline.peak_flops(torch.bfloat16) == 989e12
    assert roofline.peak_flops(torch.float32) == 67e12


CONFIGS = [("tiny", "rubiks3d", 2, 4, 32), ("small", "rubiks3d", 1, 2, 32),
           ("tiny", "rubiks3d-aq", 2, 4, 32), ("tiny", "rubiks3d", 1, 3, 37)]


def _model(tier, variant, frames):
    return create_rubiksnet(tier, 7, frames, variant, max_shift=1,
                            device="cpu",
                            generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("mode", ["infer", "train"])
@pytest.mark.parametrize("tier,variant,batch,frames,size", CONFIGS)
def test_model_flops_equals_the_flop_counter(tier, variant, batch, frames,
                                             size, mode):
    model = _model(tier, variant, frames)
    video = torch.randn((batch, frames, size, size, 3),
                        generator=torch.Generator().manual_seed(1))
    with FlopCounterMode(display=False) as counter:
        if mode == "infer":
            with torch.no_grad():
                model(video, plain=True)
        else:
            step = make_train_step(model, sgd_with_shift_mult(model, 0.01),
                                   plain=True)
            step(video, torch.arange(batch) % 7)
    assert roofline.model_flops(model, batch, frames, size, mode) == (
        counter.get_total_flops())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tier,variant,batch,frames,size", CONFIGS[:3])
def test_model_bytes_equals_the_tensors_a_forward_passes(
        tier, variant, batch, frames, size, dtype):
    model = _model(tier, variant, frames)
    model.dtype = dtype
    seen = []
    layers = [model.backbone.conv1] + [b for _, b in
                                       model.backbone.named_blocks()]
    for layer in layers:
        layer.register_forward_hook(
            lambda m, args, out: seen.append((args[0].numel(),
                                              out.numel())))
    video = torch.randn((batch, frames, size, size, 3), dtype=dtype)
    with torch.no_grad():
        logits = model(video, plain=True)
    head = seen[-1][1] + logits.numel()  # reads the last output
    itemsize = 2 if dtype == torch.bfloat16 else 4
    matrix = [model.backbone.conv1.weight, model.new_fc.weight]
    for _, blk in model.backbone.named_blocks():
        matrix += [blk.conv2_1x1.weight, blk.conv3.weight]
        if blk.shortcut is not None:
            matrix.append(blk.shortcut.weight)
        if blk.se is not None:
            matrix += [blk.se.fc[0].weight, blk.se.fc[2].weight]
    n_matrix = sum(w.numel() for w in matrix)
    n_other = (sum(p.numel() for p in model.parameters())
               + sum(b.numel() for b in model.buffers()
                     if b.is_floating_point()) - n_matrix)
    acts = sum(i + o for i, o in seen) + head
    want = (acts + n_matrix) * itemsize + n_other * 4
    assert roofline.model_bytes(model, batch, frames, size) == want
    train = roofline.model_bytes(model, batch, frames, size, "train")
    assert train > 2 * want


def test_modes_are_checked():
    model = _model("tiny", "rubiks3d", 2)
    with pytest.raises(ValueError, match="mode"):
        roofline.model_flops(model, 1, 2, 32, "serve")
    with pytest.raises(ValueError, match="mode"):
        roofline.model_bytes(model, 1, 2, 32, "step")
