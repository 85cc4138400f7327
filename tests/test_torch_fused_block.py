"""Port's fused stride-1 block run (rubiksnet_torch.ops.fused_block) vs the
JAX package: parameter stacking, the Pallas kernel in interpret mode, and
the unfused JAX block chain. On the CPU the port runs the kernel's plain
version.

Tolerance: float32 rtol/atol 2e-4, as the JAX package's own fused tests
(tests/test_fused_block.py): the same function, summed in another order
through two C x C matmuls per block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rubiksnet_torch.models.pretrained import state_dict_from_jax
from rubiksnet_torch.nn.backbone import RubiksShiftBlock as TorchBlock
from rubiksnet_torch.ops import fused_block as tfb
from rubiksnet_tpu.nn.backbone import RubiksShiftBlock as JaxBlock
from rubiksnet_tpu.ops.pallas import fused_block as jfb

torch.set_num_threads(1)

TOL = 2e-4

# Shifts covering every quantize rounding regime inside the K=1 window,
# including (K+0.5, K+1], which rounds onto the offset-(K+1) tap.
HOT = np.array([1.6, 1.51, 1.99, -1.5, 0.7, -0.7, 1.4, 0.0], np.float32)
COLD = np.array([0.51, -1.2, 1.5, 2.0, -0.49, 0.0, 1.49, -1.0], np.float32)


def make_block(rng, cin, cout, shift_scale, stride=1, aq=False, se=False):
    """JAX (params, batch_stats) of one block, float32, realistic BN. ``aq``:
    the rubiks3d-aq layout (attention weights, a (2, C) shift); ``se``: SE
    weights at reduction 12."""
    f32 = np.float32
    u = lambda lo, hi, n: jnp.asarray(rng.uniform(lo, hi, n).astype(f32))
    p = {
        "bn1": {"scale": u(0.5, 1.5, cin), "bias": u(-0.3, 0.3, cin)},
        "bn2": {"scale": u(0.5, 1.5, cout), "bias": u(-0.3, 0.3, cout)},
        "conv2": {"kernel": jnp.asarray(
            (rng.standard_normal((1, 1, cin, cout)) / np.sqrt(cin)).astype(f32))},
        "conv3": {"kernel": jnp.asarray(
            (rng.standard_normal((1, 1, cout, cout)) / np.sqrt(cout)).astype(f32))},
        "as3": {"rubiks3d": {"shift": jnp.asarray(
            rng.uniform(-shift_scale, shift_scale, (3, cout)).astype(f32))}},
    }
    if stride != 1 or cin != cout:
        p["shortcut"] = {"kernel": jnp.asarray(
            (rng.standard_normal((1, 1, cin, cout)) / np.sqrt(cin)).astype(f32))}
    s = {"bn1": {"mean": u(-0.2, 0.2, cin), "var": u(0.5, 2.0, cin)},
         "bn2": {"mean": u(-0.2, 0.2, cout), "var": u(0.5, 2.0, cout)}}
    if aq:
        p["as3"] = {"shift": p["as3"]["rubiks3d"]["shift"][1:]}
        p["aq_shift"] = {"weight": u(0.0, 1.0, (cin, 3))}
    if se:
        cr = cout // 12
        p["se"] = {
            "fc1": {"kernel": jnp.asarray(
                (rng.standard_normal((cout, cr)) / np.sqrt(cout)).astype(f32))},
            "fc2": {"kernel": jnp.asarray(
                (rng.standard_normal((cr, cout)) / np.sqrt(cr)).astype(f32))}}
    return p, s


def torch_block(p, s, cin, cout, stride=1, quantize=False):
    variant = "rubiks3d-aq" if "aq_shift" in p else "rubiks3d"
    blk = TorchBlock(cin, cout, stride, quantize, variant, "se" in p)
    blk.load_state_dict(state_dict_from_jax(p, s))
    return blk.eval()


def make_run(seed, n_blocks, c, shift_scale, hot_cold=False):
    rng = np.random.default_rng(seed)
    blocks = [make_block(rng, c, c, shift_scale) for _ in range(n_blocks)]
    if hot_cold:
        for p, _ in blocks:
            p["as3"]["rubiks3d"]["shift"] = jnp.asarray(np.stack(
                [np.resize(HOT, c), np.resize(COLD, c), np.resize(HOT, c)]))
    return rng, blocks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [False, True])
def test_stack_block_params_matches_jax(dtype, quantize):
    """Same folded BN, tap weights (K+1 tap kept only in quantize mode) and
    (in, out) matrices. Exact up to f32 rounding of the BN fold."""
    c, k = 24, 1
    _, blocks = make_run(1, 2, c, 0.9, hot_cold=quantize)
    tblocks = [torch_block(p, s, c, c, quantize=quantize) for p, s in blocks]
    vt, wm = tfb.stack_block_params(tblocks, getattr(torch, dtype), k,
                                    quantize)
    jvt, jwm = jfb.stack_block_params([p for p, _ in blocks],
                                      [s for _, s in blocks],
                                      getattr(jnp, dtype), k, quantize)
    assert vt.shape == jvt.shape and vt.dtype == torch.float32
    assert wm.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(vt.numpy(), np.asarray(jvt), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(wm.float().numpy(),
                                  np.asarray(jwm.astype(jnp.float32)))


@pytest.mark.parametrize("c,max_shift,quantize,hw", [
    (72, 1, False, (6, 6)),
    (128, 2, False, (5, 7)),
    (128, 1, True, (6, 6)),  # K+1-tap case (test_fused_block.py:229-272)
])
def test_block_run_matches_jax(c, max_shift, quantize, hw):
    hot_cold = quantize
    rng, blocks = make_run(c + max_shift, 2, c, max_shift - 0.2, hot_cold)
    x = rng.standard_normal((2, 4, *hw, c)).astype(np.float32)
    tblocks = [torch_block(p, s, c, c, quantize=quantize) for p, s in blocks]
    vt, wm = tfb.stack_block_params(tblocks, torch.float32, max_shift,
                                    quantize)
    got = tfb.fused_block_run(torch.from_numpy(x), vt, wm,
                              max_shift=max_shift).numpy()

    jvt, jwm = jfb.stack_block_params([p for p, _ in blocks],
                                      [s for _, s in blocks], jnp.float32,
                                      max_shift, quantize)
    kernel = jfb.fused_block_run(jnp.asarray(x), jvt, jwm,
                                 max_shift=max_shift, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=TOL, atol=TOL)

    jblock = JaxBlock(in_planes=c, out_planes=c, stride=1,
                      shift_backend="conv", shift_max_shift=max_shift,
                      quantize=quantize)
    chain = jnp.asarray(x)
    for p, s in blocks:
        chain = jblock.apply({"params": p, "batch_stats": s}, chain, False)
    np.testing.assert_allclose(got, np.asarray(chain), rtol=TOL, atol=TOL)

    # The port's own unfused modules (gather-form shift) agree too.
    with torch.no_grad():
        mod = torch.from_numpy(x)
        for blk in tblocks:
            mod = blk(mod)
    np.testing.assert_allclose(got, mod.numpy(), rtol=TOL, atol=TOL)


def test_taps_of_quantized_shift_sum_to_one():
    c = 16
    _, blocks = make_run(2, 1, c, 0.9, hot_cold=True)
    vt, _ = tfb.stack_block_params(
        [torch_block(p, s, c, c, quantize=True) for p, s in blocks],
        torch.float32, 1, True)
    taps = vt[:, 4:].reshape(1, 3, 4, c)
    np.testing.assert_array_equal(taps.sum(dim=2).numpy(), 1.0)


@pytest.mark.parametrize("quantize,shift", [(False, 1.2), (False, -1.01),
                                            (True, 2.5), (True, -1.51)])
def test_shift_outside_tap_window_raises(quantize, shift):
    """The tap form holds [-K, K] (fractional) or shifts rounding into
    [-K, K+1] (quantize); outside it the kernel would read zeros."""
    c = 8
    _, blocks = make_run(3, 1, c, 0.5)
    blk = torch_block(*blocks[0], c, c, quantize=quantize)
    with torch.no_grad():
        blk.as3.rubiks3d.shift[1, 3] = shift
    with pytest.raises(ValueError, match="max_shift"):
        tfb.stack_block_params([blk], torch.float32, 1, quantize)


def test_bf16_plain_run_tracks_f32():
    """bf16 rounds the stored activations and the matmul operands; over two
    blocks the result stays within 2% relative L2 of float32 (8-bit
    mantissa, a few roundings per block)."""
    c = 32
    rng, blocks = make_run(4, 2, c, 0.9)
    tblocks = [torch_block(p, s, c, c) for p, s in blocks]
    x = torch.from_numpy(rng.standard_normal((1, 4, 6, 6, c)).astype(
        np.float32))
    ref = tfb.fused_block_run(x, *tfb.stack_block_params(
        tblocks, torch.float32, 1), max_shift=1)
    got = tfb.fused_block_run(x.bfloat16(), *tfb.stack_block_params(
        tblocks, torch.bfloat16, 1), max_shift=1)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - ref).norm() / ref.norm()) < 2e-2


def test_kernel_wrapper_and_run_check_arguments():
    c = 8
    _, blocks = make_run(5, 1, c, 0.5)
    vt, wm = tfb.stack_block_params([torch_block(*blocks[0], c, c)],
                                    torch.float32, 1)
    x = torch.randn(1, 2, 4, 4, c)
    with pytest.raises(ValueError, match="CUDA"):
        tfb.fused_block_kernel(x, vt, wm, max_shift=1)
    with pytest.raises(ValueError, match="wm"):
        tfb.fused_block_run(x, vt, wm.bfloat16(), max_shift=1)
    with pytest.raises(ValueError, match="taps"):
        tfb.fused_block_run(x, vt, wm, max_shift=0)
    with pytest.raises(ValueError, match="unsupported device"):
        tfb.fused_block_run(x.to("meta"), vt.to("meta"), wm.to("meta"),
                            max_shift=1)
    assert tfb.LAUNCHES.count == 0


def _option_run(seed, c, aq, se, n_blocks=2):
    rng = np.random.default_rng(seed)
    blocks = [make_block(rng, c, c, 0.8, aq=aq, se=se)
              for _ in range(n_blocks)]
    return rng, blocks, [torch_block(p, s, c, c) for p, s in blocks]


def _stack(tblocks, dtype, aq, se, k=1):
    if aq:
        vt, wm = tfb.stack_block_params_aq(tblocks, dtype, k)
    else:
        vt, wm = tfb.stack_block_params(tblocks, dtype, k)
    return vt, wm, (tfb.stack_se_params(tblocks) if se else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_aq_and_se_params_match_jax(dtype):
    """The AQ layout (identity T taps, the 2D shift's H and W taps, three
    attention rows) and the SE array (fc1, fc2 transposed) equal the JAX
    arrays up to f32 rounding of the BN fold and the softmax."""
    c, k = 24, 1
    _, blocks, tblocks = _option_run(11, c, aq=True, se=True)
    vt, wm, se = _stack(tblocks, getattr(torch, dtype), True, True, k)
    jvt, jwm = jfb.stack_block_params_aq(
        [p for p, _ in blocks], [s for _, s in blocks], getattr(jnp, dtype), k)
    jse = jfb.stack_se_params([p for p, _ in blocks])
    assert vt.shape == jvt.shape == (2, 4 + 3 * 3 + 3, c)
    tol = 1e-6 if dtype == "float32" else 1e-2  # bf16 attention weights
    np.testing.assert_allclose(vt.numpy(), np.asarray(jvt), rtol=tol,
                               atol=tol)
    np.testing.assert_array_equal(vt[:, 4:7].numpy(), np.asarray(jvt)[:, 4:7])
    np.testing.assert_array_equal(wm.float().numpy(),
                                  np.asarray(jwm.astype(jnp.float32)))
    assert se.shape == jse.shape == (2, 2, c, c // 12)
    assert se.dtype == torch.float32
    np.testing.assert_array_equal(se.numpy(), np.asarray(jse))
    assert tfb.taps_from_rows(vt.shape[1], 4, aq=True) == 3


@pytest.mark.parametrize("aq,se", [(True, False), (False, True),
                                   (True, True)])
def test_block_run_options_match_jax(aq, se):
    """The plain run with the AQ mix, the SE gate and both, against the
    Pallas kernel in interpret mode, the unfused JAX chain and the port's
    own module path (2D shift, AttentionShift and SELayer modules)."""
    c = 72
    rng, blocks, tblocks = _option_run(20 + 2 * aq + se, c, aq, se)
    x = rng.standard_normal((2, 4, 6, 5, c)).astype(np.float32)
    vt, wm, sep = _stack(tblocks, torch.float32, aq, se)
    got = tfb.fused_block_run(torch.from_numpy(x), vt, wm, sep, aq=aq,
                              max_shift=1).numpy()

    params, stats = [p for p, _ in blocks], [s for _, s in blocks]
    stack = jfb.stack_block_params_aq if aq else jfb.stack_block_params
    jvt, jwm = stack(params, stats, jnp.float32, 1)
    jse = jfb.stack_se_params(params) if se else None
    kernel = jfb.fused_block_run(jnp.asarray(x), jvt, jwm, jse, aq=aq,
                                 max_shift=1, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=TOL, atol=TOL)

    jblock = JaxBlock(in_planes=c, out_planes=c, stride=1, use_se=se,
                      variant="rubiks3d-aq" if aq else "rubiks3d",
                      shift_backend="conv", shift_max_shift=1)
    chain = jnp.asarray(x)
    for p, s in blocks:
        chain = jblock.apply({"params": p, "batch_stats": s}, chain, False)
    np.testing.assert_allclose(got, np.asarray(chain), rtol=TOL, atol=TOL)

    with torch.no_grad():
        mod = torch.from_numpy(x)
        for blk in tblocks:
            mod = blk(mod)
    np.testing.assert_allclose(got, mod.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("aq,se", [(True, False), (False, True),
                                   (True, True)])
def test_bf16_plain_run_with_options_tracks_f32(aq, se):
    """As test_bf16_plain_run_tracks_f32: within 2% relative L2 of float32
    over two blocks; the gate is computed in float32 and the gated and the
    mixed activations are rounded to bfloat16 once."""
    c = 48
    rng, _, tblocks = _option_run(30 + 2 * aq + se, c, aq, se)
    x = torch.from_numpy(rng.standard_normal((1, 4, 6, 6, c)).astype(
        np.float32))
    vt, wm, sep = _stack(tblocks, torch.float32, aq, se)
    ref = tfb.fused_block_run(x, vt, wm, sep, aq=aq, max_shift=1)
    vt, wm, sep = _stack(tblocks, torch.bfloat16, aq, se)
    got = tfb.fused_block_run(x.bfloat16(), vt, wm, sep, aq=aq, max_shift=1)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - ref).norm() / ref.norm()) < 2e-2


def test_aq_mix_stops_at_clip_boundaries():
    """Frame 0 of a clip never reads the last frame of the clip before it:
    a batch of two clips equals the two clips run one at a time."""
    c = 24
    rng, _, tblocks = _option_run(40, c, aq=True, se=True, n_blocks=1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 4, c)).astype(
        np.float32))
    vt, wm, sep = _stack(tblocks, torch.float32, True, True)
    both = tfb.fused_block_run(x, vt, wm, sep, aq=True, max_shift=1)
    for i in range(2):
        one = tfb.fused_block_run(x[i:i + 1], vt, wm, sep, aq=True,
                                  max_shift=1)
        np.testing.assert_allclose(both[i:i + 1].numpy(), one.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_options_check_arguments():
    c = 24
    _, _, tblocks = _option_run(41, c, aq=True, se=True, n_blocks=1)
    vt, wm, sep = _stack(tblocks, torch.float32, True, True)
    x = torch.randn(1, 2, 4, 4, c)
    with pytest.raises(ValueError, match="rows is not"):
        tfb.fused_block_run(x, vt[:, :-1], wm, sep, aq=True, max_shift=1)
    with pytest.raises(ValueError, match="vt must be"):
        tfb.fused_block_run(x, vt[..., :-1], wm, sep, aq=True, max_shift=1)
    with pytest.raises(ValueError, match="se must be"):
        tfb.fused_block_run(x, vt, wm, sep.double(), aq=True, max_shift=1)
    with pytest.raises(ValueError, match="se must be"):
        tfb.fused_block_run(x, vt, wm, sep[0], aq=True, max_shift=1)
    with pytest.raises(ValueError, match="CUDA"):
        tfb.fused_block_kernel(x, vt, wm, sep, aq=True, max_shift=1)
    assert tfb.LAUNCHES.count == 0
