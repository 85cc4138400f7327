"""The order of a block's ``mid`` channels that the executor folds K2's runs
in (rubiksnet_torch.ops.fused_block.mid_channel_order, order_mid_channels,
fold_blocks): a permutation, stable, grouped by the taps' whole offsets,
and a fold under it computes each block's function.

``mid`` is internal to a block, so permuting its channels (W2's columns,
bn2's rows, the taps, the SE weights, W3's rows) leaves the block's output
the same up to the order of W3's sum: float32 rtol/atol 2e-4, the tolerance
of the fused tests against the JAX package."""

import numpy as np
import pytest
import torch

from rubiksnet_torch.models import create_rubiksnet
from rubiksnet_torch.models.fused_infer import FusedExecutor
from rubiksnet_torch.ops import fused_block as fb

torch.set_num_threads(1)

TOL = 2e-4


def keys_of(taps, max_shift):
    """Per channel, the whole offset (T, H, W) of its first non-zero tap per
    axis (0 on an axis with none), as the tap table of launch B keeps it."""
    tn = taps.shape[0] // 3
    out = []
    for c in range(taps.shape[1]):
        key = []
        for a in range(3):
            nz = torch.nonzero(taps[a * tn:(a + 1) * tn, c]).flatten()
            key.append(int(nz[0]) - max_shift if len(nz) else 0)
        out.append(tuple(key))
    return out


def random_taps(rng, c, max_shift, kind):
    shift = rng.uniform(-max_shift + 0.05, max_shift - 0.05, (3, c))
    if kind == "integer":
        shift = np.round(shift)
        shift[:, ::3] = 0.0
    taps = fb.stack_taps(torch.from_numpy(shift.astype(np.float32)),
                         torch.float32, max_shift, kind == "quantize")
    if kind == "wide":
        taps[:, ::5] = 0.25  # three or more non-zero taps on every axis
    return taps


@pytest.mark.parametrize("kind", ["frac", "integer", "quantize", "wide"])
@pytest.mark.parametrize("max_shift", [1, 4])
@pytest.mark.parametrize("c", [54, 72, 288])
def test_order_is_a_stable_permutation_grouped_by_offset(c, max_shift, kind):
    rng = np.random.default_rng(c + 10 * max_shift + len(kind))
    taps = random_taps(rng, c, max_shift, kind)
    order = fb.mid_channel_order(taps, max_shift)
    assert sorted(order.tolist()) == list(range(c))
    keys = keys_of(taps, max_shift)
    got = [keys[i] for i in order.tolist()]
    # Grouped: the keys in lexicographic (T, H, W) order; stable: equal
    # keys keep the channels' own order.
    assert got == sorted(got)
    assert order.tolist() == sorted(range(c), key=lambda i: keys[i])
    assert len(set(keys)) > 1  # the case has something to sort


def test_order_of_sorted_channels_is_the_identity():
    taps = random_taps(np.random.default_rng(3), 72, 1, "frac")
    order = fb.mid_channel_order(taps, 1)
    again = fb.mid_channel_order(taps[:, order], 1)
    assert again.tolist() == list(range(72))


@pytest.mark.parametrize("aq", [False, True])
def test_order_moves_the_mid_side_and_nothing_else(aq):
    """W2's columns, bn2's two rows, the tap rows, W3's rows and both SE
    slots follow the order; bn1 and the attention rows (x's channels)
    stay."""
    rng = np.random.default_rng(7 + aq)
    nb, c, k = 2, 24, 1
    tn = fb.kernel_taps(k)
    taps = [random_taps(rng, c, k, "frac") for _ in range(nb)]
    if aq:
        for t in taps:
            t[:tn] = 0.0
            t[k] = 1.0  # the identity T row
    head = torch.from_numpy(rng.standard_normal((nb, 4, c)).astype(np.float32))
    rows = [head, torch.stack(taps)]
    if aq:
        rows.append(torch.rand((nb, 3, c)))
    vt = torch.cat(rows, dim=1)
    wm = torch.randn((nb, 2, c, c))
    se = torch.randn((nb, 2, c, 2))
    vt2, wm2, se2 = fb.order_mid_channels(vt, wm, se, aq=aq, max_shift=k)
    for b in range(nb):
        order = fb.mid_channel_order(taps[b], k)
        assert not torch.equal(order, torch.arange(c))
        assert torch.equal(vt2[b, :2], vt[b, :2])
        assert torch.equal(vt2[b, 2:4 + 3 * tn], vt[b, 2:4 + 3 * tn][:, order])
        assert torch.equal(vt2[b, 4 + 3 * tn:], vt[b, 4 + 3 * tn:])
        assert torch.equal(wm2[b, 0], wm[b, 0][:, order])
        assert torch.equal(wm2[b, 1], wm[b, 1][order])
        assert torch.equal(se2[b], se[b][:, order])
    # New tensors: the stacked run is left as it was.
    assert vt2.data_ptr() != vt.data_ptr() and wm2.data_ptr() != wm.data_ptr()
    assert fb.order_mid_channels(vt, wm, aq=aq, max_shift=k)[2] is None


def spread_shifts(model, max_shift, seed):
    """Shifts over the whole tap window (the init draws U(-1, 1)), and BN
    statistics that are not the identity, so that every block's classes
    and channels differ."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("shift"):
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1)
                        * (max_shift - 0.05))
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.4 - 0.2)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 1.5 + 0.5)


@pytest.mark.parametrize("max_shift", [1, 4])
@pytest.mark.parametrize("tier,variant,quantize", [
    ("tiny", "rubiks3d", False),
    ("tiny", "rubiks3d-aq", False),
    ("small", "rubiks3d", False),  # the SE gate in every block
    ("tiny", "rubiks3d", True),
])
def test_ordered_fold_computes_each_blocks_function(tier, variant, quantize,
                                                    max_shift):
    """Each K2 run of the executor, folded in the gather's order, on K2's
    plain route against its blocks on the module path, float32, at the
    CPU tests' size (4 frames at 32 px)."""
    model = create_rubiksnet(tier, 5, num_frames=4, variant=variant,
                             max_shift=max_shift, quantize=quantize,
                             device="cpu",
                             generator=torch.Generator().manual_seed(1))
    spread_shifts(model, max_shift, seed=2 + max_shift)
    executor = FusedExecutor(model)
    video = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 4, 32, 32, 3)).astype(np.float32))
    runs = moved = 0
    with torch.no_grad():
        x = model.backbone.conv1(video)
        for kind, names, params in executor.steps:
            ref = x
            for name in names:
                ref = executor.blocks[name](ref)
            if kind == "block":
                vt, wm, se = params
                got = fb.fused_block_run(x, vt, wm, se, aq=executor.aq,
                                         max_shift=max_shift)
                np.testing.assert_allclose(got.numpy(), ref.numpy(),
                                           rtol=TOL, atol=TOL)
                runs += 1
                tn = fb.taps_from_rows(vt.shape[1], 4, executor.aq)
                moved += sum(
                    not torch.equal(fb.mid_channel_order(
                        vt[b, 4:4 + 3 * tn], max_shift),
                        torch.arange(vt.shape[2]))
                    for b in range(vt.shape[0]))
            x = ref
    assert runs == 5  # stage 0, then a run after each of the 4 entries
    # The folded runs are in the gather's order already: a second sort
    # leaves them, and the first one moved channels.
    assert moved == 0
    stacked = fb.stack_block_params(
        [executor.blocks[n] for n in executor.steps[0][1]], torch.float32,
        max_shift, quantize) if variant == "rubiks3d" else \
        fb.stack_block_params_aq(
            [executor.blocks[n] for n in executor.steps[0][1]], torch.float32,
            max_shift)
    assert not torch.equal(stacked[0], executor.steps[0][2][0])


@pytest.mark.parametrize("tier,variant,quantize", [
    ("tiny", "rubiks3d", False),
    ("tiny", "rubiks3d-aq", False),
    ("small", "rubiks3d", False),
    ("tiny", "rubiks3d", True),
])
def test_fold_blocks_is_the_stack_in_the_gathers_order(tier, variant,
                                                       quantize):
    """fold_blocks: the stacked run (stack_block_params or its aq form, and
    the SE weights) with mid's channels in order_mid_channels' order, bit
    for bit; the stacked arrays are left as they were."""
    k = 1
    model = create_rubiksnet(tier, 5, num_frames=4, variant=variant,
                             max_shift=k, quantize=quantize, device="cpu",
                             generator=torch.Generator().manual_seed(4))
    spread_shifts(model, k, seed=6)
    blocks = [b for _, b in model.backbone.named_blocks()
              if b.stride == 1 and b.in_planes == b.out_planes][:2]
    aq, se = variant == "rubiks3d-aq", blocks[0].se is not None
    if aq:
        vt, wm = fb.stack_block_params_aq(blocks, torch.float32, k)
    else:
        vt, wm = fb.stack_block_params(blocks, torch.float32, k, quantize)
    sep = fb.stack_se_params(blocks) if se else None
    want = fb.order_mid_channels(vt, wm, sep, aq=aq, max_shift=k)
    got = fb.fold_blocks(blocks, torch.float32, k, aq=aq, quantize=quantize,
                         se=se)
    assert (got[2] is None) == (not se)
    for g, w in zip(got, want):
        assert g is None or torch.equal(g, w)
    assert not torch.equal(got[0], vt)  # the order moved channels
