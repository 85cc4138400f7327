"""The serving stem (rubiksnet_torch/ops/stem.py, csrc/stem.cu) on the CPU.

The plain version equals ``StemConv`` bit for bit at the model's widths and
at odd sizes; the packed weight round-trips; an emulation of the kernel's
decomposition (a band's input lines staged with zero pads, the (kh, kw, c)
taps at their offsets, padded to 32 under a zero mask) equals the
convolution on every edge row and column; the operator's fake
implementation gives the output's shape and dtype at a symbolic batch; the
fused executor's logits equal those of the route it replaced
(``model.backbone.conv1``) bit for bit; and the launch counter is listed.
The kernel itself runs only on the card (``-m card``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rubiksnet_torch.models import FusedExecutor, create_rubiksnet
from rubiksnet_torch.models import fused_infer
from rubiksnet_torch.nn.backbone import StemConv
from rubiksnet_torch.ops import launch_counters, stem

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.bfloat16)
# (H, W) of the plain version's cases: 32, 56 and 112 px, an odd size.
SIZES = ((32, 32), (56, 56), (112, 112), (33, 45))
WIDTHS = (54, 72)


def stem_conv_module(c, seed=0):
    return StemConv(c, generator=torch.Generator().manual_seed(seed))


def frames(n, t, h, w, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, t, h, w, 3), generator=g).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_equals_stem_conv(size, c, dtype):
    """``stem_conv_plain`` on the packed weight is ``StemConv`` bit for bit:
    the same weight values in the same layout, the same F.conv2d."""
    conv = stem_conv_module(c)
    x = frames(1, 2, *size, dtype=dtype)
    with torch.no_grad():
        want = conv(x)
        got = stem.stem_conv_plain(x, stem.pack_stem_weight(conv.weight,
                                                            dtype))
    assert got.dtype == dtype
    assert got.shape == (1, 2, (size[0] + 1) // 2, (size[1] + 1) // 2, c)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_weight_packing_round_trips(dtype):
    conv = stem_conv_module(72)
    w = conv.weight.detach()
    packed = stem.pack_stem_weight(w, dtype)
    assert packed.shape == (stem.K, 72) and packed.dtype == dtype
    assert packed.is_contiguous()
    assert torch.equal(packed[stem.TAPS:], torch.zeros(5, 72, dtype=dtype))
    for kh in range(3):
        for kw in range(3):
            for c in range(3):
                assert torch.equal(packed[kh * 9 + kw * 3 + c],
                                   w[:, c, kh, kw].to(dtype))
    back = stem.unpack_stem_weight(packed)
    assert back.shape == (72, 3, 3, 3) and back.is_contiguous()
    assert torch.equal(back, w.to(dtype))


def emulate(x, packed, rows):
    """The kernel's decomposition in float64 on one frame x (H, W, 3): each
    band of ``rows`` output rows stages its input lines (``band_lines``)
    at ``line_pitch`` values apart behind ``LEAD`` values, zero outside the
    frame and in the pads; each pixel's A row is the stage at
    ``pixel_base + tap_offset(k)`` for k < 27 and zero past it, times the
    (32, C) weight."""
    h, w, _ = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    pitch = stem.line_pitch(w)
    wt = packed.double().numpy()
    out = np.full((ho, wo, wt.shape[1]), np.nan)
    xd = x.double().numpy()
    for band in range(-(-ho // rows)):
        lines = stem.band_lines(band, rows, h)
        stage = np.zeros(len(lines) * pitch)
        for i, ih in enumerate(lines):
            if 0 <= ih < h:
                start = i * pitch + stem.LEAD
                stage[start:start + 3 * w] = xd[ih].reshape(-1)
        nrows = (len(lines) - 1) // 2
        for q in range(nrows * wo):
            base = stem.pixel_base(q, wo, pitch)
            a = np.zeros(stem.K)
            for k in range(stem.K):
                off = stem.tap_offset(k, pitch)
                if off is not None:
                    a[k] = stage[base + off]
            r, ow = divmod(q, wo)
            out[band * rows + r, ow] = a @ wt
    return out


@pytest.mark.parametrize("rows", [1, 2, 3, None])
@pytest.mark.parametrize("size", [(9, 11), (10, 8), (7, 5), (33, 45)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_emulated_decomposition_matches_conv(size, rows):
    """Every output pixel, edge rows and columns included, of the emulated
    kernel equals the float64 convolution, at band heights that split the
    frame evenly and not (None: the plan's own)."""
    h, w = size
    conv = stem_conv_module(54, seed=3)
    packed = stem.pack_stem_weight(conv.weight, torch.float32)
    x = frames(1, 1, h, w, seed=4)[0, 0]
    if rows is None:
        rows = stem.stem_plan(h, w, 54).rows
    got = emulate(x, packed, rows)
    want = F.conv2d(x.double().permute(2, 0, 1)[None],
                    conv.weight.detach().double(), stride=2,
                    padding=1)[0].permute(1, 2, 0).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_band_lines_cover_each_output_row_once():
    """Band b's lines are 2 oh - 1 + kh of its rows; the bands tile the
    output rows (the last may be short)."""
    for h in (7, 8, 33, 224):
        ho = (h + 1) // 2
        for rows in (1, 3, 4, ho):
            seen = []
            for b in range(-(-ho // rows)):
                lines = stem.band_lines(b, rows, h)
                n = (len(lines) - 1) // 2
                assert lines[0] == 2 * b * rows - 1 and len(lines) == 2 * n + 1
                seen += range(b * rows, b * rows + n)
            assert seen == list(range(ho))


def test_plan():
    """The band rule, the copy width and the shared memory the kernel
    checks: at 224 px four rows of 112 pixels, 16-byte copies."""
    p = stem.stem_plan(224, 224, 72)
    assert (p.rows, p.bands, p.copy_bytes) == (4, 28, 16)
    assert p.smem_bytes == 2 * (32 * 72 + 2 * 9 * stem.line_pitch(224)) + (
        4 * 16 * 72 * 2)
    assert stem.stem_plan(112, 112, 72).rows == 8
    assert stem.stem_plan(224, 224, 72, 4).copy_bytes == 4
    assert stem.stem_plan(56, 42, 72).copy_bytes == 4  # 252-byte lines
    assert stem.stem_plan(33, 45, 72).copy_bytes == 2  # 270-byte lines
    assert stem.stem_plan(224, 224, 64).smem_bytes == 2 * (
        32 * 72 + 2 * 9 * stem.line_pitch(224)) + 4 * 16 * 64 * 2
    assert stem.stem_plan(7, 5, 54).rows == 4  # the whole frame
    with pytest.raises(ValueError, match="at most"):
        stem.stem_plan(224, 224, 300)


def test_fake_gives_shape_and_dtype_at_a_symbolic_batch():
    """Exported at a symbolic batch, the operator's node carries the batch
    symbol, the halved extents, C and the input's dtype."""
    packed = stem.pack_stem_weight(stem_conv_module(54).weight,
                                   torch.bfloat16)

    class Stem(torch.nn.Module):
        def forward(self, x):
            return stem.stem_conv(x, packed)

    x = frames(3, 2, 33, 45, dtype=torch.bfloat16)
    n = torch.export.Dim("n", min=1, max=8)
    program = torch.export.export(Stem(), (x,), dynamic_shapes=({0: n},))
    nodes = [nd for nd in program.graph.nodes
             if nd.op == "call_function" and "stem_conv" in str(nd.target)]
    assert len(nodes) == 1
    val = nodes[0].meta["val"]
    assert isinstance(val.shape[0], torch.SymInt)
    assert tuple(val.shape[1:]) == (2, 17, 23, 54)
    assert val.dtype == torch.bfloat16
    torch.testing.assert_close(program.module()(x), Stem()(x), rtol=0,
                               atol=0)


def test_wrong_arguments_raise():
    packed = stem.pack_stem_weight(stem_conv_module(72).weight,
                                   torch.float32)
    x = frames(1, 2, 8, 8)
    with pytest.raises(TypeError, match="compute dtype"):
        stem.stem_conv(x.to(torch.bfloat16), packed)
    with pytest.raises(ValueError, match="expected frames"):
        stem.stem_conv(x[..., :2], packed)
    with pytest.raises(ValueError, match="packed weight"):
        stem.stem_conv(x, packed[:27])
    with pytest.raises(ValueError, match="CUDA"):
        stem.stem_conv_kernel(x, packed)  # the kernel takes no CPU tensor


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("tier,variant", [("tiny", "rubiks3d"),
                                          ("tiny", "rubiks3d-aq"),
                                          ("small", "rubiks3d")])
def test_executor_logits_equal_the_replaced_route(tier, variant, dtype,
                                                   monkeypatch):
    """On the CPU the executor's logits equal, bit for bit, those of the
    route it replaced: the stem as ``model.backbone.conv1``."""
    torch.manual_seed(0)
    model = create_rubiksnet(tier, 5, 2, variant, max_shift=1,
                             device="cpu", dtype=dtype).eval()
    video = frames(2, 2, 32, 32, seed=5)
    got = FusedExecutor(model)(video)
    monkeypatch.setattr(fused_infer, "stem_conv",
                        lambda v, w: model.backbone.conv1(v))
    want = FusedExecutor(model)(video)
    assert got.dtype == dtype and torch.equal(got, want)


def test_launch_counters_list_stem_conv():
    counters = launch_counters()
    assert counters["stem_conv"] is stem.LAUNCHES
    stem.LAUNCHES.reset()
    model = create_rubiksnet("tiny", 5, 2, max_shift=1, device="cpu").eval()
    FusedExecutor(model)(frames(1, 2, 32, 32))
    assert stem.LAUNCHES.count == 0  # the plain version: no launch


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_matches_plain_on_the_card(dtype):
    """On the card: the kernel against the plain version (cuDNN, TF32 off)
    at 224 px, an odd size and width 54, each run twice bit-identically and
    counted once a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stem kernel has no CPU form")
    torch.backends.cudnn.allow_tf32 = False
    for (h, w), c in (((224, 224), 72), ((33, 45), 72), ((45, 33), 54)):
        packed = stem.pack_stem_weight(stem_conv_module(c).weight,
                                       dtype).cuda()
        x = frames(2, 8, h, w, dtype=dtype).cuda()
        before = stem.LAUNCHES.count
        got = stem.stem_conv(x, packed)
        again = stem.stem_conv(x, packed)
        want = stem.stem_conv_plain(x, packed)
        torch.cuda.synchronize()
        assert stem.LAUNCHES.count == before + 2
        assert torch.equal(got, again)
        d = (got.double() - want.double())
        if dtype == torch.float32:
            assert float(d.abs().max()) <= 1e-4 * float(want.abs().max())
        else:
            assert float(d.norm()) <= 1e-2 * float(want.double().norm())
