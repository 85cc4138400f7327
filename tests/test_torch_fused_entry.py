"""Port's fused stride-2 entry block (rubiksnet_torch.ops.fused_entry) vs the
JAX package: parameter stacking, the Pallas kernel in interpret mode, and
the unfused JAX block at stride 2. On the CPU the port runs the kernel's
plain version.

Tolerance: float32 rtol/atol 2e-4, as the JAX package's own entry tests
(tests/test_fused_entry.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rubiksnet_torch.ops import fused_block as tfb
from rubiksnet_torch.ops import fused_entry as tfe
from rubiksnet_tpu.nn.backbone import RubiksShiftBlock as JaxBlock
from rubiksnet_tpu.ops.pallas import fused_block as jfb
from rubiksnet_tpu.ops.pallas import fused_entry as jfe
from test_torch_fused_block import COLD, HOT, make_block, torch_block

torch.set_num_threads(1)

TOL = 2e-4


def make_entry(seed, cin, mid, shift_scale, hot_cold=False):
    rng = np.random.default_rng(seed)
    p, s = make_block(rng, cin, mid, shift_scale, stride=2)
    if hot_cold:
        p["as3"]["rubiks3d"]["shift"] = jnp.asarray(np.stack(
            [np.resize(HOT, mid), np.resize(COLD, mid), np.resize(HOT, mid)]))
    return rng, p, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [False, True])
def test_stack_entry_params_matches_jax(dtype, quantize):
    cin, mid, k = 8, 16, 1
    _, p, s = make_entry(1, cin, mid, 0.9, hot_cold=quantize)
    blk = torch_block(p, s, cin, mid, stride=2, quantize=quantize)
    got = tfe.stack_entry_params(blk, getattr(torch, dtype), k, quantize)
    want = jfe.stack_entry_params(p, s, getattr(jnp, dtype), k, quantize)
    for name, g, w in zip(("vt1", "vt2", "w2", "w3", "wsc"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("cin,mid,max_shift,quantize", [
    (128, 128, 1, False),  # shapes of test_fused_entry.py:66
    (8, 16, 2, False),
    (16, 16, 1, True),     # quantize, with the K+1 tap
])
def test_entry_matches_jax(cin, mid, max_shift, quantize):
    rng, p, s = make_entry(cin + mid, cin, mid, max_shift - 0.2,
                           hot_cold=quantize)
    x = rng.standard_normal((2, 3, 8, 10, cin)).astype(np.float32)
    blk = torch_block(p, s, cin, mid, stride=2, quantize=quantize)
    params = tfe.stack_entry_params(blk, torch.float32, max_shift, quantize)
    got = tfe.fused_entry_run(torch.from_numpy(x), params,
                              max_shift=max_shift).numpy()
    assert got.shape == (2, 3, 4, 5, mid)

    jparams = jfe.stack_entry_params(p, s, jnp.float32, max_shift, quantize)
    kernel = jfe.fused_entry_run(jnp.asarray(x), jparams,
                                 max_shift=max_shift, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=TOL, atol=TOL)

    jblock = JaxBlock(in_planes=cin, out_planes=mid, stride=2,
                      shift_backend="conv", shift_max_shift=max_shift,
                      quantize=quantize)
    unfused = jblock.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                           False)
    np.testing.assert_allclose(got, np.asarray(unfused), rtol=TOL, atol=TOL)

    with torch.no_grad():
        mod = blk(torch.from_numpy(x))
    np.testing.assert_allclose(got, mod.numpy(), rtol=TOL, atol=TOL)


def test_entry_checks_arguments():
    _, p, s = make_entry(2, 8, 16, 0.5)
    blk = torch_block(p, s, 8, 16, stride=2)
    params = tfe.stack_entry_params(blk, torch.float32, 1)
    with pytest.raises(ValueError, match="even"):
        tfe.fused_entry_run(torch.randn(1, 2, 5, 6, 8), params, max_shift=1)
    with pytest.raises(ValueError, match="vt1 must be"):
        tfe.fused_entry_run(torch.randn(1, 2, 4, 6, 4), params, max_shift=1)
    with pytest.raises(ValueError, match="CUDA"):
        tfe.fused_entry_kernel(torch.randn(1, 2, 4, 6, 8), params,
                               max_shift=1)
    assert tfe.LAUNCHES.count == 0


@pytest.mark.parametrize("cin,mid,max_shift,quantize", [
    (72, 144, 1, False),
    (24, 24, 2, False),
    (12, 24, 1, True),
])
def test_entry_with_se_matches_jax(cin, mid, max_shift, quantize):
    """The SE gate on the stride-2 decimated activation: the plain version
    against the Pallas kernel in interpret mode, the unfused JAX block and
    the port's own module path."""
    rng = np.random.default_rng(cin + mid + 1)
    p, s = make_block(rng, cin, mid, max_shift - 0.2, stride=2, se=True)
    if quantize:
        p["as3"]["rubiks3d"]["shift"] = jnp.asarray(np.stack(
            [np.resize(HOT, mid), np.resize(COLD, mid), np.resize(HOT, mid)]))
    x = rng.standard_normal((2, 3, 8, 10, cin)).astype(np.float32)
    blk = torch_block(p, s, cin, mid, stride=2, quantize=quantize)
    params = tfe.stack_entry_params(blk, torch.float32, max_shift, quantize)
    se = tfb.stack_se_params([blk])[0]
    got = tfe.fused_entry_run(torch.from_numpy(x), params, se,
                              max_shift=max_shift).numpy()
    assert got.shape == (2, 3, 4, 5, mid)

    jparams = jfe.stack_entry_params(p, s, jnp.float32, max_shift, quantize)
    jse = jfb.stack_se_params([p])[0]
    np.testing.assert_array_equal(se.numpy(), np.asarray(jse))
    kernel = jfe.fused_entry_run(jnp.asarray(x), jparams, jse,
                                 max_shift=max_shift, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=TOL, atol=TOL)

    jblock = JaxBlock(in_planes=cin, out_planes=mid, stride=2, use_se=True,
                      shift_backend="conv", shift_max_shift=max_shift,
                      quantize=quantize)
    unfused = jblock.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                           False)
    np.testing.assert_allclose(got, np.asarray(unfused), rtol=TOL, atol=TOL)

    with torch.no_grad():
        mod = blk(torch.from_numpy(x))
    np.testing.assert_allclose(got, mod.numpy(), rtol=TOL, atol=TOL)
    # The gate is not the identity: without it the result differs.
    bare = tfe.fused_entry_run(torch.from_numpy(x), params,
                               max_shift=max_shift).numpy()
    assert np.abs(bare - got).max() > 1e-2


def test_entry_se_checks_arguments():
    rng = np.random.default_rng(3)
    p, s = make_block(rng, 12, 24, 0.5, stride=2, se=True)
    blk = torch_block(p, s, 12, 24, stride=2)
    params = tfe.stack_entry_params(blk, torch.float32, 1)
    se = tfb.stack_se_params([blk])
    x = torch.randn(1, 2, 4, 6, 12)
    with pytest.raises(ValueError, match="se must be"):
        tfe.fused_entry_run(x, params, se, max_shift=1)  # (1, 2, C, Cr)
    with pytest.raises(ValueError, match="se must be"):
        tfe.fused_entry_run(x, params, se[0].double(), max_shift=1)
    with pytest.raises(ValueError, match="CUDA"):
        tfe.fused_entry_kernel(x, params, se[0], max_shift=1)
    assert tfe.LAUNCHES.count == 0


# ------------------------------------------- the attention mix (rubiks3d-aq)


def make_entry_aq(seed, cin, mid, shift_scale):
    rng = np.random.default_rng(seed)
    p, s = make_block(rng, cin, mid, shift_scale, stride=2, aq=True)
    return rng, p, s, torch_block(p, s, cin, mid, stride=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_entry_params_aq_matches_jax(dtype):
    """vt1 = folded bn1 then the three attention rows, vt2 = folded bn2 then
    an identity T tap row and the 2D shift's H and W taps: row for row the
    arrays of JAX's stride-1 AQ stacking of the same weights (Cin = mid, as
    Large-AQ's first entry); the matrices are the port's 1x1 convs."""
    c, k = 24, 1
    _, p, s, blk = make_entry_aq(7, c, c, 0.9)
    vt1, vt2, w2, w3, wsc = tfe.stack_entry_params_aq(
        blk, getattr(torch, dtype), k)
    jvt, _ = jfb.stack_block_params_aq([p], [s], getattr(jnp, dtype), k)
    jvt = np.asarray(jvt)[0]
    assert vt1.shape == (5, c) and vt2.shape == (2 + 3 * 3, c)
    tol = 1e-6 if dtype == "float32" else 1e-2  # bf16 attention weights
    np.testing.assert_allclose(vt1[:2].numpy(), jvt[:2], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(vt1[2:].numpy(), jvt[13:], rtol=tol, atol=tol)
    np.testing.assert_allclose(vt2[:2].numpy(), jvt[2:4], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(vt2[2:].numpy(), jvt[4:13])
    np.testing.assert_array_equal(vt2[2:5].numpy(),
                                  np.tile([[0.0], [1.0], [0.0]], (1, c)))
    dt = getattr(torch, dtype)
    for got, conv in ((w2, blk.conv2_1x1), (w3, blk.conv3),
                      (wsc, blk.shortcut)):
        assert got.dtype == dt
        torch.testing.assert_close(got, tfb.conv1x1_matrix(conv, dt))


@pytest.mark.parametrize("seed,cin,mid,max_shift,shape", [
    (0, 72, 72, 1, (2, 3, 8, 10)),   # Large-AQ's first entry: Cin = mid
    (1, 8, 16, 1, (1, 4, 6, 6)),
    (2, 24, 48, 2, (2, 2, 4, 8)),
    (3, 16, 32, 1, (1, 5, 10, 4)),
    (4, 12, 24, 1, (3, 1, 6, 6)),    # one frame: the mix's ends both zero
])
def test_entry_aq_matches_module_and_jax(seed, cin, mid, max_shift, shape):
    """The plain K3-AQ (the attention mix before W2, the stride-2 2D shift
    as an identity T row, the shortcut from the unmixed activation) equals
    the port's RubiksShiftBlock.forward in eval mode and the JAX block's
    eval apply, float32 at TOL."""
    rng, p, s, blk = make_entry_aq(100 + seed, cin, mid, max_shift - 0.2)
    x = rng.standard_normal(shape + (cin,)).astype(np.float32)
    params = tfe.stack_entry_params_aq(blk, torch.float32, max_shift)
    got = tfe.fused_entry_run(torch.from_numpy(x), params, aq=True,
                              max_shift=max_shift).numpy()
    n, t, h, w = shape
    assert got.shape == (n, t, h // 2, w // 2, mid)
    with torch.no_grad():
        mod = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, mod, rtol=TOL, atol=TOL)
    jblock = JaxBlock(in_planes=cin, out_planes=mid, stride=2,
                      variant="rubiks3d-aq", shift_backend="conv",
                      shift_max_shift=max_shift)
    unfused = jblock.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                           False)
    np.testing.assert_allclose(got, np.asarray(unfused), rtol=TOL, atol=TOL)
    # The mix is not the identity: K3 without it differs.
    bare = tfe.fused_entry_run(torch.from_numpy(x), (params[0][:2],)
                               + params[1:], max_shift=max_shift).numpy()
    if t > 1:
        assert np.abs(bare - got).max() > 1e-3


def test_bf16_plain_entry_aq_tracks_f32():
    """bfloat16 within 2% relative L2 of float32: the mixed activation is
    rounded to bfloat16 once, as K2-AQ rounds it."""
    rng, _, _, blk = make_entry_aq(9, 48, 96, 0.8)
    x = torch.from_numpy(rng.standard_normal((1, 4, 8, 8, 48)).astype(
        np.float32))
    ref = tfe.fused_entry_run(x, tfe.stack_entry_params_aq(
        blk, torch.float32, 1), aq=True, max_shift=1)
    got = tfe.fused_entry_run(x.bfloat16(), tfe.stack_entry_params_aq(
        blk, torch.bfloat16, 1), aq=True, max_shift=1)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - ref).norm() / ref.norm()) < 2e-2


def test_entry_aq_mix_stops_at_clip_boundaries():
    """Frame 0 of a clip never reads the last frame of the clip before it."""
    rng, _, _, blk = make_entry_aq(10, 16, 32, 0.8)
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 4, 16)).astype(
        np.float32))
    params = tfe.stack_entry_params_aq(blk, torch.float32, 1)
    both = tfe.fused_entry_run(x, params, aq=True, max_shift=1)
    for i in range(2):
        one = tfe.fused_entry_run(x[i:i + 1], params, aq=True, max_shift=1)
        np.testing.assert_allclose(both[i:i + 1].numpy(), one.numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_supported_declines_aq_with_quantize_or_se(dtype):
    """K3 takes the attention mix, but not with a quantized shift (the 2D
    rule rounds half away from zero and has no tap form) nor with an SE gate
    (launch A has no form with both): those entries stay on the module
    path, as every AQ entry does in the JAX executor."""
    shape = (8, 8, 56, 56, 72)
    ok = lambda **kw: tfe.fused_entry_supported(shape, 72, 144, 1, dtype,
                                                **kw)
    assert ok(aq=True) and ok() and ok(se=True) and ok(quantize=True)
    assert not ok(aq=True, quantize=True)
    assert not ok(aq=True, se=True)
    assert not ok(aq=True, se=True, quantize=True)
    assert not tfe.fused_entry_supported((8, 8, 7, 7, 72), 72, 144, 1, dtype,
                                         aq=True)  # odd H and W


def test_entry_aq_checks_arguments():
    """``aq`` is never inferred from vt1's rows: AQ params without the flag
    and plain params with it both raise, as an SE gate with the mix does."""
    _, _, _, blk = make_entry_aq(11, 12, 24, 0.5)
    params = tfe.stack_entry_params_aq(blk, torch.float32, 1)
    x = torch.randn(1, 2, 4, 6, 12)
    with pytest.raises(ValueError, match="vt1 must be"):
        tfe.fused_entry_run(x, params, max_shift=1)
    with pytest.raises(ValueError, match="vt1 must be"):
        tfe.fused_entry_run(x, (params[0][:2],) + params[1:], aq=True,
                            max_shift=1)
    se = torch.zeros((2, 24, 2))
    with pytest.raises(ValueError, match="no SE gate"):
        tfe.fused_entry_run(x, params, se, aq=True, max_shift=1)
    with pytest.raises(ValueError, match="CUDA"):
        tfe.fused_entry_kernel(x, params, aq=True, max_shift=1)
    assert tfe.LAUNCHES.count == 0 and tfe.AQ_LAUNCHES.count == 0
